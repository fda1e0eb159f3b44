#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py [--seed 0] [--waves 16] [--profile] [--min-waves 6]

Phases, each of which raises on failure:

1. build — compile every CUDA source of the port with nvcc (sm_90a), all in
   parallel, into ``build/kernels/``;
2. kernel vs plain — each CUDA kernel against its plain torch version on
   the card, whole output compared with ``torch.equal``, on small
   hand-made inputs: ``checkout_wave`` (run tiles, row tiles, tail-promoted
   tiles, a stale ``hi``), ``segment_append`` and ``segment_move`` (mixed
   sel, runs ending at the last rows of a source, all-delta and all-pad
   plans; an out-of-bounds run must raise ValueError), the two gathers
   (unsorted rids with repeats, the last row and tile) and the bitmap
   kernels (W = 1, 32 and 40 words, bit 31; ``version_aggregate`` exact on
   integer values, within ``sum_rtol`` on signed, near-2^120 and
   near-2^-100 ones, the same bits at three block_r, NaN and inf where the
   plain version has them); out-of-range indices and vids must raise;
3. read path — the versioning benchmark's SCI workload at the paper's
   SCI_1M scale (1,000 versions, 944,685 records of 100 int32 attributes),
   partitioned by LyreSplit at a storage budget of 2|R|, served by a
   pipelined ``BatchedCheckoutServer`` on the card: ``--waves`` waves of 256
   tickets over 32 unique versions each; every ticket is checked bit for bit
   against the numpy gather ``data[rlist(v)]``;
4. read timings — per-wave kernel, plain-version, ``torch.index_select``
   and device-to-host times at the read path's shapes, beside the
   bandwidth bound;
5. dataset path — a ``VersionedDataset`` over the read phase's store:
   64 seeded versions checked out tiled (``gather_row_tiles``), 16 of them
   again untiled (``gather_rows``), a ``checkout_many`` wave and 4 batch
   streams, every result checked bit for bit against numpy;
6. analytics path — the store's bitset vlists (944,685 x 32 words, 121 MB,
   uploaded once): per-version sizes, a predicate count and a column sum
   through ``version_aggregate``, and 32 versions' ``membership_scan``
   over the bitmap's word-major copy (``ops.word_major``, made once on the
   card and timed), checked against the CSR and the port's numpy query
   layer;
7. dataset and analytics timings — the four kernels of phases 5-6 at
   those shapes against their plain versions on the full inputs, timed
   beside ``torch.index_select`` (the gathers) and the bound;
   ``membership_scan`` on both layouts, each beside its own bound (the
   word-major time is the kernels line's), and the word-major copy beside
   its bound with the number of scans that pay for it; and the parts of
   one checkout (block upload, lane pad, kernel, device-to-host copy)
   apart;
8. write path — the same workload's first 900 versions as a LyreSplit
   store on the card behind a pipelined server with a
   ``RepartitionTrigger``; versions 900-999 arrive as write waves of 16
   commits (``submit_commit`` -> ``commit_many`` -> ``segment_append``),
   each followed by a read wave that includes versions just committed;
   the trigger fires one density-triggered migration (LyreSplit ->
   ``apply_migration`` -> ``migrate_superblock`` -> ``segment_move``), and
   4 more read waves follow; every ticket and the final CSR are checked;
9. write timings — ``segment_append`` at the shapes of one real write wave
   and ``segment_move`` at the real migration's, kernel against plain
   version, ``torch.index_select`` and the bandwidth bound;
10. model kernels vs plain (run after phase 2) — ``flash_attention`` (GQA
    groups 1-4 and MQA, Dh 16-256 and latent attention's q·k 192 with v
    128 (bf16: the wgmma instance, v a view of wider rows), S 128-4173
    and lengths off the tiles, causal or not; the instance each bf16 case
    ran) and
    ``ssd_scan`` (chunk 16-256, N 16-128, P 16 and 64, 1-16 chunks, a
    decay-about-1 state-carry case in both dtypes) against their plain
    versions in float32 and bfloat16, allclose at the reference's
    tolerances; an SSD
    sequence off its chunk, a head_dim of 512 and H not a multiple of Hkv
    must raise PlanError;
11. serve path — Zamba2-2.7B at full width and depth (2.34 B parameters
    from a seeded generator) through ``repro_torch.launch.serve``: 4
    prompts of 512 tokens from the CUR prompt store, the cache filled
    token by token, 32 greedy tokens, then ``make_prefill_step`` on the
    same prompts: 9 ``flash_attention`` and 54 ``ssd_scan`` launches, all
    in the prefill; cache 543 of 544; finite logits; the prefill's
    next-token logits within the driver's bf16 bound of the token path's;
12. long prefill — the same model, B = 4, S = 4096 (prefill_32k cut to one
    card): launches and finite logits; then a torch.profiler pass over 8
    decode steps and one long prefill (device busy share, time by kernel);
13. model kernel timings — both kernels at the long prefill's first
    shared attention's and first SSD layer's inputs: kernel, plain,
    ``scaled_dot_product_attention`` (flash), the bound and each design's
    own floor (flash's products with P·V twice; the scan's bytes with its
    float32 chunk states); after phase 17, flash again at OLMoE's first
    prefill layer's inputs (4, 512, 16, 16, 128: wgmma) and at
    DeepSeek-V2-Lite's latent-attention inputs (q·k 192, v 128: wgmma),
    v as the model passes it (``kv[..., qk_nope:]`` of 256-column rows,
    read in place), beside the kernel on a contiguous copy of v, the old
    path on v padded to 192 (mma_sync) and SDPA on both;
14. durable multi-tenant path (run after phase 9) — a store of its own,
    built as phase 8 builds its own (the first 900 versions, LyreSplit at
    twice their records, no superblock budget), under ``StoreDurability``
    in a fresh directory under ``build/`` (removed at the end): a
    snapshot; a ``MultiTenantServer`` of 4 threaded tenants (waves of 64
    tickets), three reading 256-ticket batches that include fresh
    versions, one writing versions 900-963 in waves of 16 commits (one
    ``commit.batch`` record and one fsync a wave); an injected
    ``journal.fsync`` fault on the next wave that leaves no trace; a
    second snapshot with the tenants' watermarks; versions 964-995 in two
    more acknowledged waves; a kill (no snapshot; the store is dropped and
    the card's allocated memory checked back to where it was);
    ``restore(device="cuda")`` timed as read + verify, replay and the
    first batch (the superblock's re-pin); 16 batches on the restored
    store; versions 996-999, a journaled migration (``segment_move``) and
    4 batches; a clean ``scrub()``.  Every ticket is checked against
    numpy, the restored store against the killed one;
15. MoE serve (run after phase 13, the Zamba2 model freed) — OLMoE-1B-7B
    as its config gives it (16 layers, d_model 2048, 64 experts top-8;
    6.92 B parameters from a seeded generator) through the serve driver
    as phase 11: 4 prompts of 512 tokens, 32 greedy tokens, one prefill;
    16 ``flash_attention`` launches (wgmma), all in the prefill;
    ``checkout_wave`` on the prompt store; cache 543 of 544; finite
    logits; the routed slots the dispatch dropped, per prefill layer.
    The served prefill (capacity factor 1.25), drops and all, must meet
    serve's prefill check against the same prefill through
    ``capacity_oracle_ffn`` with its own experts imposed, and drop the
    same slots (``served_capacity_check``).  It drops slots that the token
    path never drops; where that breaks serve's prefill check, the same
    prefill runs at capacity factor E / k (nothing drops), once with its
    own routing and once with the token path's experts imposed, and the
    latter must meet serve's prefill check and bound, its routing flips
    held to ``routing_flips`` (``full_capacity_check``); then a
    torch.profiler pass over 8 decode steps and one prefill with the MoE
    block's route, dispatch (sort, scatter), expert products and combine
    apart;
16. latent attention and shared experts — DeepSeek-V2-Lite at full width
    (kv_lora 512, qk 128 + 64, v 128, 64 routed experts top-6, 2 shared,
    vocab 102,400 tied) cut to ``MLA_DEPTH`` = 4 layers (the dense layer +
    3 MoE layers; 27 whole are 62 GB of float32 weights), the same
    traffic and checks: 4 flash launches at q·k 192, v 128 (wgmma, v
    unpadded);
17. the dense configs — Qwen1.5-4B, Mistral-NeMo-12B and Phi3-medium-14B
    at full width and vocab, 2 of 40 layers: 4 prompts of 128, 8 greedy
    tokens, the prefill check, 2 flash launches each;
18. dense training (after phase 17, the serve models freed) —
    InternLM2-1.8B as its config gives it (24 layers, d_model 2048, 16 / 8
    heads of 128, d_ff 8192, vocab 92,544, remat on; 1.70 B seeded
    parameters) through ``repro_torch.launch.train``: its corpus (SCI,
    12 versions of 257-token records, LyreSplit, a ``VersionedDataset``
    checked out by ``gather_row_tiles``), batches of 8 × 256, AdamW (lr
    3e-4, cosine, warmup 10).  Step 0's loss and every gradient through
    the kernels against the same step with the plain flash version on
    the card, forward and backward (``step0_check``: the loss within
    ``prefill_bound``, each leaf within sqrt(2) times it); 6
    uninterrupted steps; an interrupted
    run: 3 steps, a full-size ``CheckpointStore.save``, the trainer and
    the store dropped, the store reopened, ``restore_or_init`` (through
    ``resume_latest(device="cuda")``) bit-exact against the saved
    parameters at cursor 3, 3 more steps on a fresh AdamW: the resumed
    batches equal the uninterrupted run's steps 3-5, its first losses
    equal within ``RERUN_LOSS_RTOL``, every loss and grad norm finite;
    48 flash launches a step (the forward and remat's recompute) and 24
    of the backward kernel; then a torch.profiler step (forward,
    backward, optimizer ranges; the flash kernel's share) and the flash
    Function's halves at the training shape and at the train-4k cell's
    call: the backward kernel's dq, dk and dv against the plain-torch
    backward's (``ops._flash_bwd``) on the same inputs within
    ``BWD_TOL`` relative L2, and its time beside the forward kernel's,
    the plain backward's and SDPA's backward;
19. SSM training — Mamba2-780M as its config gives it (48 layers,
    d_model 1536, N 128, P 64, chunk 256, 2 microbatches; 0.78 B
    parameters), the same traffic, step 0 against the plain ``ssd_scan``
    on the card, 2 steps (96 ``ssd_scan`` launches a microbatch), a
    profiled step;
20. encoder-decoder serve (after phase 17's timings, the serve models
    freed; before phase 18) — Seamless-M4T-medium as its config gives it
    (12 + 12 layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab
    256,206 tied; 0.72 B seeded parameters), driven through the serving
    steps (the serve driver refuses an encoder-decoder, as the
    reference's does): 4 prompts of 512 tokens from the CUR prompt store
    (``checkout_wave``), 544 seeded bf16 frame embeddings a request (the
    stub frontend), the decode cache's encoder K/V filled from the
    prefill's own encoder code (``fill_cross_cache``), the prompts fed
    token by token, 32 greedy tokens, one ``make_prefill_step``: 48
    ``flash_attention`` launches (12 in the cache's encoder pass, 36 in
    the prefill: the encoder's non-causal self-attention, the decoder's
    causal self-attention and its cross-attention, 512 queries against
    544 frames); the prefill within ``prefill_bound`` of the token path's
    and of the same prefill through flash's plain version; cache 543 of
    544;
21. vision-language serve — LLaVA-NeXT-34B at full width (d_model 7168,
    56 / 8 heads of 128, d_ff 20,480, vocab 64,000 untied) cut to
    ``LLAVA_DEPTH`` = 4 of 60 layers (60 are 138 GB of float32), through
    ``phase_family_serve``: 4 prompts of 1,024 tokens (the first 576 the
    anyres base tile's patch slots; serve's prefill passes the prompts'
    own token embeddings there), 8 greedy tokens, 4 flash launches (GQA,
    7 query heads a kv head: wgmma); then a prefill with seeded random
    patch embeddings and ``loss_fn`` (its patch mask) on it, each through
    the kernel against flash's plain version, within ``prefill_bound``;
22. the paged KV cache — the reference's default ``PagedConfig`` at
    phase 21's geometry (4 layers, 8 kv heads of 128, bf16: a 268 MB pool
    on the card), batch 8: the 4 served requests' K/V appended token by
    token from phase 21's dense cache, every gather bit-identical to the
    dense rows; request 0 forked into slots 4-7 and 8 seeded tokens
    appended to each (one copied tail page a fork); three requests
    released and their pages reused; every state leaf equal to a CPU run
    of the same operations; appends and gathers timed on the host clock.
    Then ``flash_attention`` timed at the first inputs of each kind of
    phases 20-21;
23. the compile analysis (after phase 19, the training models freed) —
    (b) three cells at the one-card sizes phases 12, 15 and 18 run
    (Zamba2-2.7B's prefill at 4 × 4096, OLMoE-1B-7B's at 4 × 512,
    InternLM2-1.8B's train step at 8 × 256): each step counted by
    ``launch.op_count.analyze`` on ``meta`` tensors, then run on the card
    with the model kernels and with their plain versions; the kernel
    run's ms beside the roofline bound on the kernel path, and both runs'
    peak device memory beside the count's estimate, which the plain run
    (the same program, freed at the same points) must meet within
    ``PEAK_RTOL``; flash timed at InternLM2's training shape; then (a)
    ``launch.dryrun.main`` over all 10 configs × 4 shapes on ``meta`` on
    each of the three meshes (one card, and rank 0 of the 256- and
    512-rank production meshes under a fake group, its collectives
    counted), run since the build in ``DRYRUN_WORKERS`` background
    processes at the lowest priority and collected here: 96 ``ok`` and 24
    ``skipped`` (``long_500k`` on the full-attention configs) or the phase
    fails; the 120 records in ``chiprun_out/dryrun/``,
    ``launch.report``'s tables (one a mesh) in
    ``chiprun_out/dryrun_report.md``;
24. the mesh (after phase 19, before phase 23) — a one-rank NCCL group
    and a (pod, data, model) = (1, 1, 1) ``DeviceMesh`` through
    ``launch.mesh.make_mesh`` (no other backend is tried), InternLM2-1.8B
    at full size laid out by ``param_specs`` (FSDP DTensors), residuals
    from ``ef_init``, 3 steps of 8 × 256 seeded tokens through the
    compressed train step (``grad_compress=True``: the int8 exchange over
    "pod"): the first step's residuals against ``g − round(g/s)·s`` from
    ``accumulate_grads`` on the same weights and batch (``g``) and the
    reference leaf's scale ``s``, taken apart from the step in plain torch
    (``residual_check``), ``|e| ≤ s/2``; its loss against that plain
    loss; later losses finite; 48 flash launches a step; then a
    checkpoint of the phase's one-device state (layer 0's and the final
    norm's parameters and residuals) restored onto the NCCL mesh by
    ``elastic_reshard``, bit-exact; ms a step beside phase 18's, the
    residuals' bytes and the peak memory; the group freed.  One card
    holds one NCCL rank (NCCL refuses two ranks on one device), so the
    numerics across ranks are held on the CPU by gloo ranks
    (``tests/test_torch_data_parallel.py``), as the reference holds its
    own on faked host devices;
25. the model axis (after phase 24, before phase 23) — DeepSeek-V2-Lite
    at full width cut to ``MLA_DEPTH`` = 4 layers (latent attention, the
    dense SwiGLU layer, 3 MoE layers of 64 experts with shared experts;
    2.05 B seeded parameters) on the train launcher's traffic (2 steps of
    8 × 256 seeded tokens in the config's 4 microbatches): first the
    one-device step (``ctx=None``), then, from the same seeded weights, a
    one-rank NCCL ("data", "model") = (1, 1) ``DeviceMesh`` through
    ``launch.mesh.make_mesh``, the weights laid out by ``param_specs``
    and the plain train step through the tensor- and expert-parallel
    layers (``copy_to_tp``/``reduce_from_tp`` around the column- and
    row-parallel products, the token-parallel split and the all-to-all
    pair of the experts, their collectives on a one-rank group); the
    first loss and grad norm equal to the one-device step's within
    ``TP_RTOL`` (on one rank the slices and the capacity are the
    one-device path's, and the collectives copy), the second loss
    finite, the model group's collectives by kind as
    ``expected_tp_calls`` reckons, 64 flash launches; then the first MoE
    layer's leaves (2.28 GB) saved from the one-rank state and restored
    onto the mesh by ``elastic_reshard``, bit-exact; ms a step beside the
    one-device step's, the peaks; the group freed.  The numerics across
    model ranks are held on the CPU by gloo ranks
    (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_expert_parallel.py``), as the reference holds its
    own on faked host devices;
26. the model axis's second half (after phase 25, before phase 23) —
    (b) first, each rank's part at the production model axis of 16, run
    rank by rank on the card and combined as the collectives would: the
    sequence-sharded attention at LLaVA-NeXT-34B's shape (56 heads, 8 kv,
    Dh 128, B 1, S 4096; 256 query rows a rank, ≈235 MB of float32 logits
    each) against the whole-sequence flash kernel, its backward's dQ rows
    and summed dK/dV partials against the one-slice backward; Zamba2's
    first SSD layer at the long prefill's shape, 80 heads in 16
    ``ssd_scan`` launches of 5 against the whole launch's heads, and the
    gated norm's sum of squares over the 16 slices; LLaVA's decode
    attention at a cache of 4096 cut into 16 slices and merged against
    the one-slice decode.  Then (a): Zamba2-2.7B whole served on one
    device and, on the same seeded weights laid out by ``param_specs``,
    on a one-rank NCCL ("data", "model") = (1, 1) mesh (no other backend
    is tried): 4 × 512 seeded tokens through ``make_prefill_step``, then
    8 ``make_serve_step`` decodes from a seeded cache of 512 positions in
    528 slots cut by ``cache_specs`` (the mesh path decodes the
    one-device path's tokens); the logits within
    ``launch.serve.prefill_bound`` of the one-device serve's, the greedy
    tokens equal where the top-2 gap is clear of it, the model group's
    collectives as ``expected_serve_calls`` reckons, 9 flash and 54 SSD
    launches; ms of both serves, the peaks; the group freed.  One card
    holds one NCCL rank, so the numerics across model ranks are held on
    the CPU by gloo ranks (``tests/test_torch_seq_parallel.py``,
    ``tests/test_torch_ssd_parallel.py``,
    ``tests/test_torch_mesh_serve.py``).
27. one production rank (after phase 26, before phase 23) — in a
    subprocess (this process holds phases 24-26's NCCL group; a process
    holds one): rank 0 of the 256-rank (data 16, model 16) mesh on a
    group of the ``"fake"`` backend (``launch.mesh.counting_group``), the
    first of ``RANK_STEP_CELLS`` whose counted peak (``launch.dryrun``)
    is under ``RANK_PEAK_LIMIT``: Zamba2-2.7B ``train_4k`` at full width
    and depth, B 16 × 4096 a rank in 4 microbatches, 2 of 32 attention
    heads and 5 of 80 SSD heads, in the reference's activation layout
    (the residual stream the rank's 256 of 4096 rows between blocks, the
    vocabulary its 2,016 of 32,256 columns, the cross-entropy over the
    shards).  Rank 0's shards of the parameters are made on the card from
    a seeded generator per leaf and rank (no whole model is made), and
    its step runs ``RANK_STEP_STEPS`` times after one
    untimed step: ms a step against the count's bound for rank 0, max
    (compute, memory on the kernel path) with the collectives free (a
    fake group moves no bytes and leaves a gather's output unwritten, so
    only memory and time are measured, never values), the peak device
    memory against the count's estimate within ``PEAK_RTOL`` or the phase
    fails, the flash and ``ssd_scan`` launches; then one launch of each at
    its first call's shape on seeded inputs against its plain version
    within ``FLASH_TOL`` and ``SSD_TOL``.  Then, in a second subprocess,
    rank 0 of LLaVA-NeXT-34B ``train_4k`` (B 16 × 4096 in 4
    microbatches), whose 8 kv heads do not divide the model axis: its
    attention weights are the rank's storage shards, gathered whole in
    bf16 only at each use (``models.layers.at_use``), its sequence-sharded
    attention plain torch (no hand-written kernel on this path); one
    untimed and one timed step, its peak against the count's estimate
    within ``PEAK_RTOL``, and the phase fails unless the step gathered
    weights at use (``sharding.TP_CALLS["gather_weight"]``);

Phases 3, 5, 6, 8, 11, 12, 14 (twice: from the tenants to the kill, and
from the restore to the end), 15-17 and 21 (once a config), 18 (the
uninterrupted and the interrupted run), 19 (its two steps), 20 (from
the prompt store to the prefill), 24 (its three steps), 25 (its two
TP/EP steps; the one-device steps have their own window), 26 (the
mesh serve: its prefill and decodes) and 27 (its timed steps) each set every
kernel's launch count to 0 just before they drive their path and read the
counts just after; launches made to compare or time a kernel fall outside
those windows, and so do phase 23's.
The kernels line's ``flash_attention`` launches are the sum over the
model paths (phases 11, 15-18, 20, 21 and 24-27), ``flash_backward``'s
over the training phases (18, 19, 24 and 25; phase 18 alone is held to
its count), ``ssd_scan``'s over phases 11, 19, 26 and 27, and
``gather_row_tiles``'s over phases 5, 18 and 19.  ``flash_backward``
replaces no TPU kernel (the reference's backward is jnp): its row's
times are phase 18's at the train-4k cell's call.
TF32 is off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False): the float32 plain versions
compare in full float32.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Full per-wave numbers go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result, when
there is no CUDA device or the port's sources are missing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
# kernel -> (its library under src/repro_torch/csrc, the TPU kernel it
# replaces)
KERNELS = {
    "checkout_wave": ("checkout_wave",
                      "src/repro/kernels/checkout_batched.py:210"),
    "segment_append": ("segment_append",
                       "src/repro/kernels/segment_append.py:71"),
    "segment_move": ("segment_move", "src/repro/kernels/segment_move.py:67"),
    "gather_rows": ("checkout_gather",
                    "src/repro/kernels/checkout_gather.py:56"),
    "gather_row_tiles": ("checkout_gather",
                         "src/repro/kernels/checkout_gather.py:82"),
    "membership_scan": ("membership_scan",
                        "src/repro/kernels/vlist_membership.py:38"),
    "version_aggregate": ("version_aggregate",
                          "src/repro/kernels/version_agg.py:45"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:101"),
    "ssd_scan": ("ssd_scan", "src/repro/kernels/ssd_scan.py:88"),
}
# the libraries to build: the kernels' and the flash backward's, which
# replaces no TPU kernel (the reference's backward is jnp)
SOURCES = sorted({lib for lib, _ in KERNELS.values()} | {"flash_backward"})
# the backward kernel against the plain float32 backward on the same
# inputs, relative L2 of dq, dk and dv: the card tests' bf16 GRAD_TOL
# (its P enters dv's product as bf16, and the outputs round to bf16)
BWD_TOL = 2 * 2.0 ** -8
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 on the tensor cores, dense
DATASET_VERSIONS = 64    # tiled checkouts in the dataset phase
DATASET_UNTILED = 16     # of them checked out again with gather_rows
DATASET_STREAMS = 4      # batch streams of 8 steps
DATASET_SEQ_LEN = 1023   # tokens a sequence (a training row is 1024)
SCAN_VERSIONS = 32       # membership scans in the analytics phase
WRITE_BASE = 900         # versions in the write phase's starting store
WRITE_WAVE = 16          # commits per write wave
DURABLE_READERS = ("r0", "r1", "r2")   # the durable phase's read tenants
DURABLE_WRITER = "w"                   # and its write tenant
DURABLE_MAX_WAVE = 64    # tickets a granted wave (the tenancy bench's)
DURABLE_RESTORED_BATCHES = 16   # 256-ticket batches on the restored store
# the write phase's RepartitionTrigger: every wave below density 1.0 counts
# toward the streak, so it fires on a wave count: 6 read waves in a row fire
# LyreSplit once, after the 6th write wave, and the 5 read waves left cannot
# fire it again (``--min-waves`` changes the count; see PERF.md)
TRIGGER = {"min_waves": 6, "low_density": 1.0, "min_gain": 1.02}
DEVICE = "cuda"                  # where the model phases run
MODEL_ARCH = "zamba2_2_7b"      # the serve phases' model, at full width
SERVE_REQUESTS = 4               # the token-by-token cross-check: 4 prompts
SERVE_PROMPT = 512               # of 512 tokens, then 32 greedy tokens
SERVE_DECODE = 32
MOE_ARCH = "olmoe_1b_7b"         # phase 15: MoE at full size
MLA_ARCH = "deepseek_v2_lite_16b"  # phase 16: latent attention + shared
MLA_DEPTH = 4        # experts at full width: the dense layer + 3 MoE layers
#                      (27 whole: 62 GB of float32 weights)
DENSE_ARCHS = ("qwen15_4b", "mistral_nemo_12b", "phi3_medium_14b")
DENSE_DEPTH = 2      # phase 17: full width and vocab, 2 of 40 layers,
DENSE_PROMPT = 128   # 4 prompts of 128 tokens, 8 greedy tokens
DENSE_DECODE = 8
ENCDEC_ARCH = "seamless_m4t_medium"   # phase 20: the encoder-decoder whole
# its stub frontend's frames: as many as the decode cache has slots (the
# decode attends to every slot of enc_k/enc_v)
ENCDEC_FRAMES = SERVE_PROMPT + SERVE_DECODE
VLM_ARCH = "llava_next_34b"      # phase 21: full width, LLAVA_DEPTH of 60
LLAVA_DEPTH = 4                  # layers (60 whole: 138 GB of float32)
VLM_PROMPT = 1024                # 4 prompts of 1,024 tokens, the first 576
VLM_DECODE = 8                   # the anyres base tile's patch slots
TRAIN_ARCH = "internlm2_1_8b"    # phase 18: dense training at full size
TRAIN_SSM_ARCH = "mamba2_780m"   # phase 19: SSM training at full size
TRAIN_BATCH = 8                  # the train launcher's traffic: batches of
TRAIN_SEQ = 256                  # 8 sequences of 256 tokens
TRAIN_STEPS = 6                  # phase 18's uninterrupted run; its
TRAIN_PREEMPT = 3                # interrupted run stops after 3, resumes
TRAIN_SSM_STEPS = 2
# the interrupted run's first losses against the uninterrupted run's: the
# same code on the same inputs, but the embedding's gradient is a
# scatter-add whose float32 sums land in another order each run
RERUN_LOSS_RTOL = 1e-4
LONG_BATCH = 4                   # the long prefill: prefill_32k (B 32,
LONG_SEQ = 4096                  # S 32768) cut to one card and the time
# the device kernels the long prefill runs through the two model kernels'
# wrappers (bf16): the flash instance and the SSD's three passes
MODEL_KERNEL_NAMES = ("flash_fwd_wgmma_kernel", "ssd_chunk_state_kernel",
                      "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
# kernel vs plain, per dtype: the reference's own tolerances
# (tests/test_flash_attention.py, tests/test_ssd_kernel.py); the two sum
# in different orders, and a bf16 output is one rounding
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SSD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 5e-2}


def gpu_line(torch) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn()`` for kernels of a few microseconds,
    where the host's launch cost through the Python wrappers is larger
    than the kernel: the launches are queued behind a spin kernel
    (``torch.cuda._sleep``), so the device runs them back to back, and the
    spin is checked to be still running when the last one is queued (else
    it is lengthened and the run repeated).  With ``flush``, each launch
    gets its own pair of CUDA events and ``flush()`` (a read larger than
    the 50 MB L2) runs between them, so every launch finds its inputs out
    of the cache."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        spun = torch.cuda.Event()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(2 * reps if flush else 2)]
        torch.cuda._sleep(cycles)
        spun.record()
        if flush is None:
            marks[0].record()
            for _ in range(reps):
                fn()
            marks[1].record()
        else:
            for k in range(reps):
                flush()
                marks[2 * k].record()
                fn()
                marks[2 * k + 1].record()
        covered = not spun.query()
        marks[-1].synchronize()
        if covered:
            return sum(marks[k].elapsed_time(marks[k + 1])
                       for k in range(0, len(marks), 2)) / reps
        cycles *= 4
    raise AssertionError("the host could not queue the launches ahead of "
                         "the device")


def launch_counts() -> dict:
    """Every kernel's launch count, by name."""
    from repro_torch.kernels import (checkout_batched as cb,
                                     checkout_gather as cg,
                                     flash_attention as fa,
                                     segment_append as sa, segment_move as sm,
                                     ssd_scan as ss, version_agg as va,
                                     vlist_membership as vm)
    return {"checkout_wave": cb.LAUNCHES, "segment_append": sa.LAUNCHES,
            "segment_move": sm.LAUNCHES, **cg.LAUNCHES,
            "membership_scan": vm.LAUNCHES, "version_aggregate": va.LAUNCHES,
            "flash_attention": fa.LAUNCHES,
            "flash_backward": fa.BWD_LAUNCHES, "ssd_scan": ss.LAUNCHES}


def zero_launch_counts() -> None:
    from repro_torch.kernels import (checkout_batched as cb,
                                     checkout_gather as cg,
                                     flash_attention as fa,
                                     segment_append as sa, segment_move as sm,
                                     ssd_scan as ss, version_agg as va,
                                     vlist_membership as vm)
    cb.LAUNCHES = sa.LAUNCHES = sm.LAUNCHES = vm.LAUNCHES = va.LAUNCHES = 0
    fa.LAUNCHES = fa.BWD_LAUNCHES = ss.LAUNCHES = 0
    for k in cg.LAUNCHES:
        cg.LAUNCHES[k] = 0


def phase_build(report: dict) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    report["build_s"] = time.perf_counter() - t0
    for name in SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {SOURCES} in {report['build_s']:.2f} s")


def small_plan_cases(torch, np):
    """Hand-made plans over a small superblock: run tiles, row tiles,
    tail-promoted tiles, and a deliberately stale ``hi``."""
    bn = 8
    cases = []
    for dtype, d in ((torch.int32, 128), (torch.float32, 512),
                     (torch.int16, 256)):
        r = 96
        gen = torch.Generator().manual_seed(d)
        data = torch.randint(-1000, 1000, (r, d), generator=gen).to(dtype)
        starts = np.concatenate([
            np.arange(0, 8),                      # run tile
            np.array([3, 17, 5, 90, 2, 2, 64, 1]),  # row tile
            np.array([40, 41, 42, 43, 43, 43, 43, 43]),  # tail, promoted
            np.arange(88, 96),                    # run ending at R
            np.array([50, 51, 52, 53, 53, 53, 53, 53]),  # stale hi -> rows
        ]).astype(np.int32)
        mode = np.array([1, 0, 1, 1, 1], np.int32)
        hi = np.array([48, 96, 48, 96, 56], np.int32)  # last: 50+8 > 56
        cases.append((f"{dtype}-D{d}", data, starts, mode, hi, bn))
    return cases


def phase_small(torch, np, report: dict) -> None:
    from repro_torch.kernels import checkout_batched as cb
    cases = small_plan_cases(torch, np)
    for name, data, starts, mode, hi, bn in cases:
        dev = data.cuda()
        s, m, h = (torch.from_numpy(a).cuda() for a in (starts, mode, hi))
        got = cb.checkout_wave(dev, s, m, h, block_n=bn)
        want = cb.checkout_wave_plain(dev, s, m, h, block_n=bn)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"checkout_wave != plain on case {name}")
        # the stale-hi tile must have gathered rows (50..53, then 53s),
        # not the run 50..57
        ref = data[torch.from_numpy(starts[32:40]).long()]
        if not torch.equal(got[32:40].cpu(), ref):
            raise AssertionError(f"stale hi did not degrade on {name}")
    report["small_cases"] = len(cases)
    print(f"kernel vs plain: {report['small_cases']} hand-made plans equal")


def segment_plan_cases(np):
    """Hand-made (kernel, sel, starts) plans over a 96-row src and a 40-row
    delta: mixed sel with runs ending at the last BN rows of each source
    and an unaligned start, an all-delta plan, an all-pad plan; then the
    out-of-bounds plans that must raise."""
    i32 = functools.partial(np.array, dtype=np.int32)
    ok = [
        ("segment_append", i32([0, 1, 2, 0, 1, 0, 2, 1]),
         i32([0, 8, 0, 88, 32, 5, 77, 3])),
        ("segment_append", i32([1] * 5), i32([0, 8, 16, 24, 32])),
        ("segment_append", i32([2] * 4), i32([0] * 4)),
        ("segment_move", i32([0, 1, 0, 1, 1, 0]), i32([88, 32, 0, 3, 0, 41])),
        ("segment_move", i32([1] * 5), i32([32, 24, 16, 8, 0])),
    ]
    bad = [("segment_append", i32([0, 0]), i32([0, 89])),
           ("segment_append", i32([1, 2]), i32([33, 0])),
           ("segment_append", i32([0, 3]), i32([0, 0])),
           ("segment_move", i32([0, 1]), i32([-1, 0])),
           ("segment_move", i32([1, 0]), i32([33, 0]))]
    return ok, bad


def phase_segments(torch, np, report: dict) -> None:
    """Both segment kernels against their plain versions on hand-made
    plans, in int32 (D=128), float32 (D=512) and int16 (D=256)."""
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    kernels = {"segment_append": (sa.segment_append, sa.segment_append_plain),
               "segment_move": (sm.segment_move, sm.segment_move_plain)}
    ok, bad = segment_plan_cases(np)
    n = 0
    for dtype, d in ((torch.int32, 128), (torch.float32, 512),
                     (torch.int16, 256)):
        gen = torch.Generator().manual_seed(d)
        src = torch.randint(-1000, 1000, (96, d), generator=gen).to(dtype)
        delta = torch.randint(-1000, 1000, (40, d), generator=gen).to(dtype)
        src, delta = src.cuda(), delta.cuda()
        for name, sel, starts in ok:
            kernel, plain = kernels[name]
            got = kernel(src, delta, sel, starts)
            want = plain(src, delta, torch.from_numpy(sel).cuda(),
                         torch.from_numpy(starts).cuda())
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on {dtype}-D{d} "
                                     f"sel={sel.tolist()}")
            n += 1
        for name, sel, starts in bad:
            try:
                kernels[name][0](src, delta, sel, starts)
            except ValueError:
                n += 1
                continue
            raise AssertionError(f"{name} ran an out-of-bounds plan "
                                 f"sel={sel.tolist()} starts={starts.tolist()}")
    report["segment_small_cases"] = n
    print(f"segment kernels vs plain: {n} hand-made plans equal or refused")


def phase_gather_bitmap_small(torch, np, report: dict) -> None:
    """The gathers and the bitmap kernels against their plain versions on
    hand-made inputs: unsorted rids with repeats and the last row, tiles
    out of order with the last one, in int32 (D=128) and float16 (D=256);
    bitmaps of W = 1, 32 and 40 words: ``membership_cases`` and, over R =
    2500 rows (a multiple neither of BR nor of 16 nor of the aggregate's
    chunk), ``aggregate_cases``.  Out-of-range indices and vids must raise
    PlanError on the host."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import checkout_gather as cg
    from repro_torch.kernels import version_agg as va
    from repro_torch.kernels import vlist_membership as vm
    n = 0
    rids = np.array([47, 3, 3, 20, 0, 9, 31, 8, 47, 12, 5], np.int32)
    tiles = np.array([5, 0, 2, 2, 3], np.int32)
    for dtype, d in ((torch.int32, 128), (torch.float16, 256)):
        data = torch.arange(48 * d).reshape(48, d).to(dtype).cuda()
        pairs = ((cg.gather_rows(data, rids), cg.gather_rows_plain(
                     data, torch.from_numpy(rids).cuda())),
                 (cg.gather_row_tiles(data, tiles), cg.gather_row_tiles_plain(
                     data, torch.from_numpy(tiles).cuda())))
        torch.cuda.synchronize()
        for got, want in pairs:
            if not torch.equal(got, want):
                raise AssertionError(f"a gather != plain on {dtype}-D{d}")
            n += 1
        for fn, bad in ((cg.gather_rows, [0, 48]),
                        (cg.gather_row_tiles, [6])):
            try:
                fn(data, np.array(bad))
            except build.PlanError:
                n += 1
                continue
            raise AssertionError(f"{fn.__name__} took indices {bad}")
    rng = np.random.default_rng(13)
    r = 2500
    for n_versions in (20, 1000, 1270):
        n += membership_cases(torch, np, rng, n_versions)
        rlists = [np.flatnonzero(rng.random(r) < 0.3)
                  for _ in range(n_versions)]
        bm = ops.build_bitmap(rlists, r)
        words = ops.as_bitmap(bm, "cuda")
        n += aggregate_cases(torch, np, rng, bm, words)
        try:
            vm.membership_scan(words, 32 * words.shape[1])
        except build.PlanError:
            n += 1
        else:
            raise AssertionError("membership_scan took a vid past W")
    report["gather_bitmap_small_cases"] = n
    print(f"gather and bitmap kernels vs plain: {n} hand-made cases equal "
          "or refused")


def membership_cases(torch, np, rng, n_versions: int) -> int:
    """``membership_scan`` on the card against its plain version, exactly
    one launch a case, over seeded bitmaps of ``n_versions`` versions
    (version 31 on every 7th row, the last on every row) at R = 2500, 2501
    and 2503 (R mod 4 = 0, 1, 3) and 7 (below every BR), each in three
    layouts: row-major, ``word_major`` and a word-major view whose runs
    start 4 bytes past a 16-byte boundary; BR 1024, 96, 100 and 98 (not a
    multiple of 4); versions 0, 5, 31 (bit 31) and the last.  Masks and
    counts are exact and the counts sum to the version's size; the ``vec4``
    instance runs exactly where the run is word-major, 16-byte aligned and
    BR % 4 == 0 (W = 1 row-major is such a run), ``strided`` elsewhere.
    Returns the number of cases."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import vlist_membership as vm
    n = 0
    vids = sorted({0, 5, min(31, n_versions - 1), n_versions - 1})
    for r in (2500, 2501, 2503, 7):
        rlists = [np.flatnonzero(rng.random(r) < 0.3)
                  for _ in range(n_versions)]
        if n_versions > 31:
            rlists[31] = np.arange(0, r, 7)
        rlists[-1] = np.arange(r)
        words = ops.as_bitmap(ops.build_bitmap(rlists, r), "cuda")
        w = words.shape[1]
        wm = ops.word_major(words)
        storage = torch.empty((w, wm.stride(1) + 4), dtype=torch.int32,
                              device=words.device)
        off = storage[:, 1:r + 1]
        off.copy_(words.t())
        layouts = (("row-major", words, w == 1), ("word-major", wm, True),
                   ("word-major off 16 bytes", off.t(), False))
        for name, x, aligned in layouts:
            for br in (1024, 96, 100, 98):
                for vid in vids:
                    want_i = "vec4" if aligned and br % 4 == 0 else "strided"
                    before = vm.LAUNCHES
                    mask, cnt = vm.membership_scan(x, vid, block_r=br)
                    launched = vm.LAUNCHES - before
                    want_m, want_c = vm.membership_scan_plain(x, vid,
                                                              block_r=br)
                    torch.cuda.synchronize()
                    if not (launched == 1 and torch.equal(mask, want_m)
                            and torch.equal(cnt, want_c)
                            and cnt.shape == (-(-r // br),)
                            and int(cnt.sum()) == len(rlists[vid])
                            and vm.instance(x, vid, br) == want_i):
                        raise AssertionError(
                            f"membership_scan != plain ({launched} launches"
                            f", instance {vm.instance(x, vid, br)}), {name} "
                            f"R={r} W={w} BR={br} vid={vid}")
                    n += 1
    return n


def aggregate_cases(torch, np, rng, bm, words) -> int:
    """``version_aggregate`` on the card against its plain version over
    one bitmap: integer values (sums exact, ``torch.equal``), signed
    floats, signed floats with 64 seeded rows of magnitude 2^120 to 2^121
    (whose sums stay below FLT_MAX in any order) and magnitudes near
    2^-100 (within ``sum_rtol`` of the sum of the terms' absolute values,
    taken in float64 on the host), each at block_r 1024, 96 and 100 with
    the same bits every time; then a NaN row and +inf rows (NaN and inf
    where the plain version has them, the same bits on two runs).  Returns
    the number of cases."""
    from repro_torch.kernels import version_agg as va
    r = bm.shape[0]
    bits = np.unpackbits(bm.view(np.uint8), axis=1, bitorder="little")
    bits = bits.T.astype(np.float64)
    sign = np.where(rng.random(r) < 0.5, -1.0, 1.0)
    ints = rng.integers(0, 100, r).astype(np.float32)
    big = rng.random(r) * 2 - 1
    rows = rng.choice(r, 64, replace=False)
    big[rows] = sign[rows] * np.ldexp(1 + rng.random(64), 120)
    cases = [("ints", ints, True),
             ("signed", rng.random(r) * 2 - 1, False),
             ("2^120", big, False),
             ("2^-100", sign * np.ldexp(1 + rng.random(r), -100), False)]
    w, n = bm.shape[1], 0
    for name, values, exact in cases:
        values = values.astype(np.float32)
        vals = torch.from_numpy(values).cuda()
        runs = [va.version_aggregate(words, vals, block_r=br)
                for br in (1024, 96, 100)]
        want = va.version_aggregate_plain(words, vals)
        torch.cuda.synchronize()
        got = runs[0]
        if not all(torch.equal(got, x) for x in runs[1:]):
            raise AssertionError(f"version_aggregate ({name}, W={w}) "
                                 "differs between runs")
        if exact:
            ok = torch.equal(got, want)
        else:
            bound = sum_rtol(r) * (bits @ np.abs(values.astype(np.float64)))
            err = np.abs((got - want).cpu().numpy().astype(np.float64))
            ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
        if not ok:
            raise AssertionError(f"version_aggregate != plain ({name}, "
                                 f"W={w})")
        n += 1
    for row, bad in ((7, np.nan), (r - 1, np.inf), (1234, np.inf)):
        values = ints.copy()
        values[row] = bad
        vals = torch.from_numpy(values).cuda()
        got = va.version_aggregate(words, vals)
        again = va.version_aggregate(words, vals)
        want = va.version_aggregate_plain(words, vals)
        torch.cuda.synchronize()
        if not (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(got.nan_to_num(), want.nan_to_num())
                and torch.equal(torch.isnan(got), torch.isnan(again))
                and torch.equal(got.nan_to_num(), again.nan_to_num())):
            raise AssertionError(f"version_aggregate with {bad} at row {row}"
                                 f" != plain (W={w}): nan at "
                                 f"{int(torch.isnan(got).sum())} of "
                                 f"{int(torch.isnan(want).sum())}")
        n += 1
    return n


def make_store(np, seed: int, report: dict):
    from repro_torch.core import (generate, lyresplit_for_budget,
                                  store_from_arrays, to_tree)
    t0 = time.perf_counter()
    w = generate("SCI", n_versions=1000, inserts=630, n_branches=100,
                 n_attrs=100, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    split = lyresplit_for_budget(tree, 2 * w.n_records)
    store = store_from_arrays(w.graph.indptr, w.graph.indices, w.n_records,
                              w.data, split.best.assignment, device="cuda")
    report["setup_s"] = time.perf_counter() - t0
    report["store"] = {"versions": w.n_versions, "records": w.n_records,
                       "memberships": w.n_edges,
                       "partitions": len(store.partitions),
                       "stored_rows": store.storage_cost()}
    print(f"store: {report['store']} built in {report['setup_s']:.1f} s")
    return store, w, tree


def wave_traffic(np, seed: int, n_waves: int, n_versions: int):
    """Duplicate-heavy waves: 256 tickets over 32 unique versions each."""
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        uniq = rng.choice(n_versions, 32, replace=False)
        tickets = np.concatenate([uniq, rng.choice(uniq, 256 - 32)])
        waves.append(rng.permutation(tickets).tolist())
    return waves


def phase_main(torch, np, store, waves, report: dict) -> None:
    """The main path: a pipelined server on the card, every ticket checked
    against the numpy gather of the store's record pool."""
    from repro_torch.core.checkout import peek_superblock
    from repro_torch.serve import BatchedCheckoutServer
    # the server's latency clock stops while the client checks results,
    # so ticket latencies measure the server alone
    paused = [0.0]
    srv = BatchedCheckoutServer(
        store, pipeline=True, clock=lambda: time.monotonic() - paused[0])
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    report["warmup_s"] = time.perf_counter() - t0
    checked = 0
    serve_s = 0.0

    def check(delivered, vids):
        nonlocal checked
        t_check = time.monotonic()
        oracle = {}
        for m, v in zip(delivered, vids):
            want = oracle.get(v)
            if want is None:
                want = oracle[v] = (m, store.data[store.graph.rlist(v)])
                if not np.array_equal(m, want[1]):
                    raise AssertionError(f"ticket for version {v} differs "
                                         "from data[rlist(v)]")
            elif m is not want[0] and not np.array_equal(m, want[1]):
                raise AssertionError(f"ticket for version {v} differs")
            checked += 1
        paused[0] += time.monotonic() - t_check

    zero_launch_counts()                     # read path window opens
    t_wall = time.perf_counter()
    prev = None
    flush_ms = []
    for vids in waves:
        t = time.perf_counter()
        srv.submit_many(vids)
        delivered = srv.flush()
        flush_ms.append(1e3 * (time.perf_counter() - t))
        serve_s += flush_ms[-1] / 1e3
        if prev is not None:
            check(delivered, prev)
        prev = vids
    t = time.perf_counter()
    delivered = srv.deliver()
    serve_s += time.perf_counter() - t
    check(delivered, prev)
    wall_s = time.perf_counter() - t_wall
    counts = launch_counts()                 # read path window closes
    launches = counts.pop("checkout_wave")
    if any(counts.values()):
        raise AssertionError(f"the read path launched another kernel: "
                             f"{counts}")
    srv.close()
    sb = peek_superblock(store)
    st = srv.stats
    if launches < len(waves):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(waves)} waves")
    if sb is None or sb.uploads != 1:
        raise AssertionError("superblock was not uploaded exactly once")
    if st.degraded_waves or st.requeues or checked != 256 * len(waves):
        raise AssertionError(f"serve stats off: {st}, checked {checked}")
    lease = getattr(store, "_read_leases", None)
    if int(store._inflight_waves) != 0 or (lease and lease.held()):
        raise AssertionError("read leases not balanced after close")
    report["main"] = {
        "waves": len(waves), "tickets": checked, "launches": launches,
        "uploads": sb.uploads, "degraded_waves": st.degraded_waves,
        "rows_served": st.rows_served, "serve_s": serve_s,
        "wall_s_with_checks": wall_s,
        "ms_per_wave_serve": 1e3 * serve_s / len(waves),
        "flush_ms": flush_ms,
        "tickets_per_s_serve": checked / serve_s,
        "p50_ticket_latency_ms": 1e3 * st.p50_latency_s,
        "max_ticket_latency_ms": 1e3 * st.max_latency_s,
        "superblock_bytes": int(sb.host.nbytes)}
    print(f"main path: {checked} tickets in {len(waves)} waves bit-identical"
          f"; launches={launches} uploads={sb.uploads} "
          f"degraded_waves={st.degraded_waves}")
    print(f"serve: {report['main']['ms_per_wave_serve']:.2f} ms/wave, "
          f"{report['main']['tickets_per_s_serve']:.0f} tickets/s, "
          f"p50 ticket latency {report['main']['p50_ticket_latency_ms']:.2f}"
          f" ms, max {report['main']['max_ticket_latency_ms']:.2f} ms "
          f"(host clock, client checks excluded)")


def phase_timing(torch, np, store, waves, report: dict) -> dict:
    """Per-wave device times at the main path's shapes, after the run:
    kernel, plain version, index_select yardstick, device-to-host copy; and
    the full-size kernel-vs-plain comparison on every wave."""
    from repro_torch.core.checkout import peek_superblock, plan_wave
    from repro_torch.kernels import checkout_batched as cb
    sb = peek_superblock(store)
    data = sb.device()
    row_bytes = data.shape[1] * data.element_size()
    per_wave = []
    for vids in waves:
        uniq = sorted(set(vids))
        t_plan = time.perf_counter()
        wp = plan_wave(store, uniq, sb)
        plan_ms = 1e3 * (time.perf_counter() - t_plan)
        s, m, h = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
                   for a in (wp.plan.starts, wp.plan.mode, wp.hi))
        got = cb.checkout_wave(data, s, m, h, block_n=sb.block_n)
        want = cb.checkout_wave_plain(data, s, m, h, block_n=sb.block_n)
        if not torch.equal(got, want):
            raise AssertionError("full-size checkout_wave != plain")
        err = int((got.long() - want.long()).abs().max())
        t = int(m.shape[0])
        src = cb.source_rows(s, m, h, block_n=sb.block_n)
        unique_rows = int(torch.unique(src).numel())
        s_long = s.long()
        del want
        out_bytes = t * sb.block_n * row_bytes
        plan_bytes = 4 * (t * sb.block_n + 2 * t)
        bytes_min = unique_rows * row_bytes + out_bytes + plan_bytes
        host = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
        w = {"tiles": t, "run_tiles": int(m.sum()), "max_abs_err": err,
             "plan_host_ms": plan_ms,
             "out_bytes": out_bytes, "unique_rows_read": unique_rows,
             "bytes_min": bytes_min,
             "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
             "ms": cuda_ms(torch, lambda: cb.checkout_wave(
                 data, s, m, h, block_n=sb.block_n), 5),
             "plain_ms": cuda_ms(torch, lambda: cb.checkout_wave_plain(
                 data, s, m, h, block_n=sb.block_n), 2),
             "library_ms": cuda_ms(torch, lambda: torch.index_select(
                 data, 0, s_long), 5),
             "d2h_ms": cuda_ms(torch, lambda: host.copy_(
                 got, non_blocking=True), 2)}
        per_wave.append(w)
        del got, host
    torch.cuda.synchronize()
    mean = {k: float(np.mean([w[k] for w in per_wave]))
            for k in per_wave[0]}
    report["per_wave"] = per_wave
    report["per_wave_mean"] = mean
    print(f"per wave (mean of {len(per_wave)}): kernel {mean['ms']:.3f} ms, "
          f"plain {mean['plain_ms']:.3f} ms, index_select "
          f"{mean['library_ms']:.3f} ms, bound {mean['bound_ms']:.3f} ms, "
          f"D2H {mean['d2h_ms']:.3f} ms, plan_wave on the host "
          f"{mean['plan_host_ms']:.2f} ms, "
          f"{mean['out_bytes'] / 1e6:.1f} MB out")
    return mean


def read_wave_vids(np, rng, n_versions: int, fresh=()):
    """256 tickets over 32 unique versions drawn from ``n_versions``,
    including (up to) 4 of the versions ``fresh`` just committed."""
    new = rng.choice(np.asarray(fresh, np.int64), min(4, len(fresh)),
                     replace=False)
    rest = rng.choice(np.setdiff1d(np.arange(n_versions), new),
                      32 - len(new), replace=False)
    uniq = np.concatenate([new, rest])
    tickets = np.concatenate([uniq, rng.choice(uniq, 256 - 32)])
    return rng.permutation(tickets).tolist()


def phase_write(torch, np, w, tree, seed: int, trigger_kw: dict,
                report: dict) -> dict:
    """The online write path at full width: write waves of ``WRITE_WAVE``
    commits land through ``segment_append``, a read wave follows each, the
    density trigger migrates once through ``segment_move``, and 4 read
    waves follow.  Returns the first write wave's and the migration's
    kernel inputs, captured for ``phase_write_timing``."""
    from repro_torch.core import checkout as ck
    from repro_torch.core import lyresplit_for_budget, store_from_arrays
    from repro_torch.core.online import RepartitionTrigger
    from repro_torch.core.version_graph import WeightedTree
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchedCheckoutServer
    t0 = time.perf_counter()
    n0 = WRITE_BASE
    ip, ind = w.graph.indptr, w.graph.indices
    pool = int(ind[:ip[n0]].max()) + 1     # records the first n0 versions own
    base_tree = WeightedTree(parent=tree.parent[:n0].copy(),
                             n_records=tree.n_records[:n0].copy(),
                             edge_w=tree.edge_w[:n0].copy())
    split = lyresplit_for_budget(base_tree, 2 * pool)
    store = store_from_arrays(ip[:n0 + 1], ind[:ip[n0]], pool, w.data[:pool],
                              split.best.assignment, device="cuda")
    trigger = RepartitionTrigger(store, base_tree, **trigger_kw)
    srv = BatchedCheckoutServer(store, pipeline=True, trigger=trigger)
    srv.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"write store: {n0} versions, {pool} records, "
          f"{len(store.partitions)} partitions, built in {setup_s:.1f} s")

    captured: dict = {}
    extensions: list = []
    real = {"segment_append": ops.segment_append,
            "segment_move": ops.segment_move}
    real_extend = ck.extend_superblock_after_commit

    def capture(name):
        def wrapped(src, delta, sel, starts, **kw):
            if name not in captured:        # the first call of each kernel
                captured[name] = {
                    "src": src, "sel": np.array(sel),
                    "starts": np.array(starts),
                    "delta": None if delta is None else np.array(delta)}
            return real[name](src, delta, sel, starts, **kw)
        return wrapped

    def extend(*args, **kwargs):
        new_sb, st = real_extend(*args, **kwargs)
        extensions.append(st)
        return new_sb, st

    rng = np.random.default_rng(seed + 2)
    checked = 0

    def check(delivered, vids):
        nonlocal checked
        oracle: dict = {}
        for m, v in zip(delivered, vids):
            want = oracle.get(v)
            if want is None or m is not want[0]:
                ref = want[1] if want is not None \
                    else w.data[w.graph.rlist(v)]
                if not np.array_equal(m, ref):
                    raise AssertionError(f"write phase: ticket for version "
                                         f"{v} differs from data[rlist(v)]")
                oracle[v] = (m, ref)
            checked += 1

    def read_wave(vids):
        tickets = srv.submit_many(vids)
        srv.flush()                 # dispatch; nothing else is in flight
        srv.deliver()               # join; the trigger observes here
        check([srv.result(t) for t in tickets], vids)

    ops.segment_append = capture("segment_append")
    ops.segment_move = capture("segment_move")
    ck.extend_superblock_after_commit = extend
    evictions0 = getattr(store, "_superblock_evictions", 0)
    commit_ms, write_vids, cur = [], [], pool
    try:
        zero_launch_counts()                          # write path window
        t_wall = time.perf_counter()
        for lo in range(n0, w.n_versions, WRITE_WAVE):
            vs = list(range(lo, min(lo + WRITE_WAVE, w.n_versions)))
            commits = []
            for v in vs:
                # the generator allocates rids densely in version order:
                # a version's fresh rids are those past the pool before it
                rl = w.graph.rlist(v)
                fresh = rl[rl >= cur]
                commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                                "new_rows": w.data[fresh]})
                cur += len(fresh)
            tickets = srv.submit_commit(commits)
            t = time.perf_counter()
            srv.flush()             # the write wave lands as commit_many
            torch.cuda.synchronize()
            commit_ms.append(1e3 * (time.perf_counter() - t))
            got = [int(srv.result(k)) for k in tickets]
            if got != vs:
                raise AssertionError(f"write tickets gave {got}, not {vs}")
            write_vids += got
            sb = ck.peek_superblock(store)
            if (sb is None or sb._device is None or sb.epoch != store.epoch
                    or sb._device.device.type != store.device.type):
                raise AssertionError("no device superblock at the store's "
                                     "epoch after a write wave")
            if getattr(store, "_superblock_evictions", 0) != evictions0:
                raise AssertionError("a write wave evicted the superblock")
            read_wave(read_wave_vids(np, rng, vs[-1] + 1, vs))
        if not trigger.reports:
            raise AssertionError("the trigger did not fire in the write "
                                 "phase")
        prev = None                 # 4 pipelined read waves after it
        for _ in range(4):
            vids = read_wave_vids(np, rng, w.n_versions)
            srv.submit_many(vids)
            out = srv.flush()
            if prev is not None:
                check(out, prev)
            prev = vids
        check(srv.deliver(), prev)
        wall_s = time.perf_counter() - t_wall
        launches = launch_counts()                    # window closes
    finally:
        ops.segment_append = real["segment_append"]
        ops.segment_move = real["segment_move"]
        ck.extend_superblock_after_commit = real_extend
    srv.close()
    n_write = len(commit_ms)
    n_read = n_write + 4
    st = srv.stats
    rep = trigger.reports[0]
    mig = rep.superblock
    if write_vids != list(range(n0, w.n_versions)):
        raise AssertionError("write tickets did not return the versions "
                             "in order")
    if not (np.array_equal(store.graph.indptr, w.graph.indptr)
            and np.array_equal(store.graph.indices, w.graph.indices)
            and store.graph.n_records == w.n_records):
        raise AssertionError("the store's CSR differs from the workload's")
    if launches["segment_append"] != n_write:
        raise AssertionError(f"segment_append launched "
                             f"{launches['segment_append']} times for "
                             f"{n_write} write waves")
    if len(trigger.reports) != 1 or st.repartitions != 1:
        raise AssertionError(
            f"{len(trigger.reports)} migrations fired, not exactly one, at "
            f"density-stats waves {[r.at_wave for r in trigger.reports]}")
    if mig is None or not mig.used_device or mig.reused_tiles <= 0:
        raise AssertionError(f"the migration did not reuse device tiles: "
                             f"{mig}")
    others = {k: n for k, n in launches.items() if n and k not in (
        "checkout_wave", "segment_append", "segment_move")}
    if others:
        raise AssertionError(f"the write path launched {others}")
    if launches["segment_move"] != 1:
        raise AssertionError(f"segment_move launched "
                             f"{launches['segment_move']} times, not once")
    if launches["checkout_wave"] < n_read:
        raise AssertionError(f"checkout_wave launched "
                             f"{launches['checkout_wave']} times for "
                             f"{n_read} read waves")
    if (checked != 256 * n_read or st.degraded_waves or st.requeues
            or st.commit_waves != n_write
            or st.commits_ingested != len(write_vids)):
        raise AssertionError(f"write phase stats off: {st}, checked "
                             f"{checked}")
    lease = getattr(store, "_read_leases", None)
    if int(store._inflight_waves) != 0 or (lease and lease.held()):
        raise AssertionError("read leases not balanced after close")
    report["write"] = {
        "trigger": trigger_kw, "setup_s": setup_s, "write_waves": n_write,
        "commits": len(write_vids), "read_waves": n_read,
        "tickets": checked, "launches": launches, "wall_s": wall_s,
        "commit_wave_ms": commit_ms,
        "extension_host_ms": [1e3 * e.wall_s for e in extensions],
        "extensions": [dataclasses.asdict(e) for e in extensions],
        "migration": {k: v for k, v in dataclasses.asdict(rep).items()
                      if k != "superblock"},
        "migration_superblock": dataclasses.asdict(mig),
        "partitions_after": len(store.partitions),
        "superblock_bytes": int(ck.peek_superblock(store).host.nbytes)}
    print(f"write path: {len(write_vids)} commits in {n_write} write waves, "
          f"{checked} tickets in {n_read} read waves bit-identical; "
          f"launches={launches}")
    print(f"write waves (host clock, commit_many + superblock extension): "
          f"{' '.join(f'{m:.0f}' for m in commit_ms)} ms; of which the "
          f"extension (plan + host mirror + launch) "
          f"{' '.join(f'{1e3 * e.wall_s:.0f}' for e in extensions)} ms")
    print(f"migration at wave {rep.at_wave}: {rep.n_partitions_before} -> "
          f"{rep.n_partitions_after} partitions, {rep.wall_s * 1e3:.0f} ms "
          f"host (LyreSplit + plan + apply + superblock), superblock "
          f"{mig.wall_s * 1e3:.0f} ms, {mig.reused_tiles}/{mig.n_tiles} "
          f"tiles reused, {mig.bytes_uploaded / 1e6:.1f} MB uploaded")
    return captured


def phase_write_timing(torch, np, captured: dict, report: dict) -> dict:
    """Each segment kernel at the shapes the write path gave it (the first
    write wave, the migration): kernel against plain version on the full
    inputs, then kernel, plain, ``torch.index_select`` over a pre-built
    ``[src; delta; zero tile]`` (the cat happens before the timed window),
    the bandwidth bound, and the delta's host-to-device upload as the path
    makes it (pageable)."""
    from repro_torch.kernels import segment_append as sa
    from repro_torch.kernels import segment_move as sm
    out = {}
    for name, mod, plain, pad in (
            ("segment_append", sa, sa.segment_append_plain, True),
            ("segment_move", sm, sm.segment_move_plain, False)):
        c = captured[name]
        src = c["src"]
        bn = 8
        delta = (src.new_zeros((bn, src.shape[1])) if c["delta"] is None
                 else torch.from_numpy(c["delta"]).cuda())
        sel_d, starts_d = sa.upload(src.device, c["sel"], c["starts"])
        got = mod._launch(src, delta, sel_d, starts_d, bn)
        want = plain(src, delta, sel_d, starts_d, block_n=bn)
        err = 0 if torch.equal(got, want) else \
            int((got.double() - want.double()).abs().max())
        if err:
            raise AssertionError(f"full-size {name} != plain (max abs "
                                 f"err {err})")
        del got, want
        t = len(c["sel"])
        row_bytes = src.shape[1] * src.element_size()
        reads = int((c["sel"] != 2).sum()) if pad else t
        bytes_min = (reads + t) * bn * row_bytes + 8 * t
        rows = sa.source_rows(sel_d, starts_d, src.shape[0], delta.shape[0],
                              block_n=bn, pad=pad)
        stack = torch.cat([src, delta, src.new_zeros((bn, src.shape[1]))])
        out[name] = {
            "tiles": t, "reused_tiles": int((c["sel"] == 0).sum()),
            "delta_tiles": int((c["sel"] == 1).sum()),
            "pad_tiles": int((c["sel"] == 2).sum()) if pad else 0,
            "bytes_min": bytes_min, "max_abs_err": err,
            "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
            "ms": cuda_ms(torch, lambda: mod._launch(
                src, delta, sel_d, starts_d, bn), 5),
            "plain_ms": cuda_ms(torch, lambda: plain(
                src, delta, sel_d, starts_d, block_n=bn), 2),
            "library_ms": cuda_ms(torch, lambda: torch.index_select(
                stack, 0, rows), 5),
            "delta_bytes": 0 if c["delta"] is None else c["delta"].nbytes,
            "upload_ms": 0.0 if c["delta"] is None else cuda_ms(
                torch, lambda: torch.from_numpy(c["delta"]).to(src.device),
                3)}
        del stack, rows
        o = out[name]
        print(f"{name} ({t} tiles, {bytes_min / 1e6:.0f} MB moved): kernel "
              f"{o['ms']:.3f} ms, plain {o['plain_ms']:.3f} ms, "
              f"index_select {o['library_ms']:.3f} ms, bound "
              f"{o['bound_ms']:.3f} ms; delta upload "
              f"{o['delta_bytes'] / 1e6:.1f} MB in {o['upload_ms']:.3f} ms")
    captured.clear()
    torch.cuda.synchronize()
    report["write_timing"] = out
    return out


def commit_wave(w, tree, lo: int, hi: int, cur: int):
    """The commits of versions ``lo..hi-1`` as ``commit_many`` dicts, and
    the record pool after them (the generator allocates rids densely in
    version order: a version's fresh rids are those past the pool before
    it)."""
    commits = []
    for v in range(lo, hi):
        rl = w.graph.rlist(v)
        fresh = rl[rl >= cur]
        commits.append({"parent": int(tree.parent[v]), "rlist": rl,
                        "new_rows": w.data[fresh]})
        cur += len(fresh)
    return commits, cur


def durable_window(grants: list, readers) -> dict:
    """The grant log's contention window, windowed as the multi-tenant
    benchmark windows it: the read tenants' grants up to the first one
    that drains (a tenant's total grants reached)."""
    total = {t: grants.count(t) for t in readers}
    window = {t: 0 for t in readers}
    for g in grants:
        if g not in window:
            continue
        window[g] += 1
        if window[g] == total[g]:
            break
    return window


def resume_tickets(mts, watermarks: dict) -> None:
    """Start each tenant's tickets, client and server side, at its
    restored watermark: the coordinator has no restore hook of its own,
    and a restored stream must not re-mint a pre-kill ticket id."""
    for t, server in mts.tenant_servers().items():
        mts._tenant(t).next_ticket = server._next_ticket = int(watermarks[t])


def phase_durable(torch, np, w, tree, seed: int, gpu: str,
                  report: dict) -> None:
    """The durable multi-tenant write path at SCI_1M, on a store of its
    own built as the write phase builds its own (the first
    ``WRITE_BASE`` versions, LyreSplit at twice their records, no
    superblock budget): a snapshot; four threaded tenants (three readers,
    one writer of ``WRITE_WAVE``-commit waves, each one ``commit.batch``
    record and one fsync); an injected ``journal.fsync`` fault that leaves
    no trace; a second snapshot with the tenants' watermarks; two more
    acknowledged write waves; a kill; ``restore(device="cuda")`` timed in
    its parts; 16 read batches on the restored store; the last commits, a
    journaled migration and 4 read batches; and a clean scrub.  Every
    ticket is checked against numpy."""
    import shutil
    import tempfile
    import types
    import weakref
    from repro_torch.core import durability as dmod
    from repro_torch.core import lyresplit_for_budget, store_from_arrays
    from repro_torch.core.checkout import (migrate_superblock,
                                           peek_superblock, take_superblock)
    from repro_torch.core.durability import (StoreDurability,
                                             snapshot_roundtrip_equal)
    from repro_torch.core.faults import FaultPlan, InjectedFault, install
    from repro_torch.core.journal import get_journal, read_records
    from repro_torch.core.partition import plan_migration
    from repro_torch.core.version_graph import WeightedTree
    from repro_torch.serve import MultiTenantServer, TenantQuota, jain_index
    readers, writer = DURABLE_READERS, DURABLE_WRITER
    tenants = (*readers, writer)
    rng = np.random.default_rng(seed + 3)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    n0 = WRITE_BASE
    ip, ind = w.graph.indptr, w.graph.indices
    pool = int(ind[:ip[n0]].max()) + 1
    base_tree = WeightedTree(parent=tree.parent[:n0].copy(),
                             n_records=tree.n_records[:n0].copy(),
                             edge_w=tree.edge_w[:n0].copy())
    split = lyresplit_for_budget(base_tree, 2 * pool)
    store = store_from_arrays(ip[:n0 + 1], ind[:ip[n0]], pool, w.data[:pool],
                              split.best.assignment, device=DEVICE)
    root = tempfile.mkdtemp(prefix="durable-", dir=ROOT / "build")
    out: dict = {"gpu": gpu, "dir_bytes": {}}

    def dir_bytes() -> int:
        return sum(p.stat().st_size for p in Path(root).iterdir())

    oracle: dict = {}

    def check(tickets_vids, results):
        for v, m in zip(tickets_vids, results):
            want = oracle.get(v)
            if want is None:
                want = oracle[v] = w.data[w.graph.rlist(v)]
            if not np.array_equal(np.asarray(m), want):
                raise AssertionError(f"durable phase: ticket for version {v}"
                                     " differs from data[rlist(v)]")
        return len(tickets_vids)

    opened: list = []     # servers to stop if a check fails

    def make_mts(s):
        # room for every batch the restored store's serving submits
        # before it collects: no shed is part of this path
        cap = 256 * DURABLE_RESTORED_BATCHES
        opened.append(MultiTenantServer(
            s, threads=True, max_backlog=len(tenants) * cap,
            quotas={t: TenantQuota(max_inflight=cap,
                                   max_wave=DURABLE_MAX_WAVE)
                    for t in tenants}))
        return opened[-1]

    def read_round(mts, n_live, fresh):
        """One 256-ticket batch for every reader; returns the tickets."""
        sub = {}
        for t in readers:
            vids = read_wave_vids(np, rng, n_live, fresh)
            sub[t] = (vids, mts.submit_many(t, vids))
        return sub

    def collect(mts, sub):
        n = 0
        for t, (vids, tks) in sub.items():
            n += check(vids, mts.results(t, tks, timeout=600))
        return n

    try:
        # 1. store and first snapshot
        dur = StoreDurability(root)
        t = time.perf_counter()
        dur.snapshot(store)
        out["snapshot1_s"] = time.perf_counter() - t
        out["dir_bytes"]["snapshot1"] = dir_bytes()
        print(f"durable store: {n0} versions, {pool} records, "
              f"{len(store.partitions)} partitions; snapshot 1 in "
              f"{out['snapshot1_s']:.2f} s, {out['dir_bytes']['snapshot1']} "
              f"bytes on disk (host clock; {gpu})")
        # 2. tenants: three readers and a writer, on worker threads
        mts = make_mts(store)
        mts.warmup()
        torch.cuda.synchronize()
        zero_launch_counts()                          # window 1 opens
        cur, fresh, acked, checked, write_waves = pool, [], [], 0, 0
        journals = []                                 # (write_s, synced)
        j = dur.journal
        for lo in range(n0, n0 + 4 * WRITE_WAVE, WRITE_WAVE):
            commits, cur = commit_wave(w, tree, lo, lo + WRITE_WAVE, cur)
            synced = j.synced
            wt = mts.submit_commit(writer, commits)
            sub = read_round(mts, store.graph.n_versions, fresh)
            fresh = [int(v) for v in mts.results(writer, wt, timeout=600)]
            if fresh != list(range(lo, lo + WRITE_WAVE)):
                raise AssertionError(f"write tickets gave {fresh}")
            if j.synced != synced + 1:
                raise AssertionError(f"a write wave paid {j.synced - synced}"
                                     " fsyncs, not one")
            acked += fresh
            write_waves += 1
            checked += collect(mts, sub)
        # 3. a fault: the next write wave's fsync fails
        lo = n0 + 4 * WRITE_WAVE
        commits, cur_after = commit_wave(w, tree, lo, lo + WRITE_WAVE, cur)
        n_before, epoch_before = store.graph.n_versions, store.epoch
        repairs, synced = j.repairs, j.synced
        plan = FaultPlan.single("journal.fsync")
        install(store, plan)
        try:
            mts.drain(timeout=600)
            wt = mts.submit_commit(writer, commits)
            for k in wt:
                try:
                    mts.result(writer, k, timeout=600)
                except InjectedFault:
                    continue
                raise AssertionError("the faulted write wave was "
                                     "acknowledged")
        finally:
            install(store, None)
        recs, bad = read_records(j.path)
        if ([r.site for r in plan.fired] != ["journal.fsync"]
                or j.repairs != repairs + 1 or j.synced != synced
                or (store.graph.n_versions, store.epoch)
                != (n_before, epoch_before) or bad is not None
                or any(r.kind == "commit.batch"
                       and r.payload["vid0"] >= lo for r in recs)):
            raise AssertionError("the failed write wave left a trace: "
                                 f"fired {plan.fired}, repairs "
                                 f"{j.repairs - repairs}, versions "
                                 f"{store.graph.n_versions}")
        # 4. second snapshot, with the tenants' watermarks
        if not mts.drain(timeout=600):
            raise AssertionError("the tenants did not drain")
        journals.append((j.write_s, j.synced))
        t = time.perf_counter()
        snap2 = dur.snapshot(store, servers=mts)
        out["snapshot2_s"] = time.perf_counter() - t
        out["dir_bytes"]["snapshot2"] = dir_bytes()
        out["dedup_ratio"] = dur.dedup_ratio()
        print(f"snapshot 2 (tenant watermarks "
              f"{snap2.meta['ticket_watermarks']}) in "
              f"{out['snapshot2_s']:.2f} s, dedup ratio "
              f"{out['dedup_ratio']:.4f} against snapshot 1, "
              f"{out['dir_bytes']['snapshot2']} bytes on disk (host clock; "
              f"{gpu})")
        j = dur.journal
        for lo in range(lo, lo + 2 * WRITE_WAVE, WRITE_WAVE):
            commits, cur = commit_wave(w, tree, lo, lo + WRITE_WAVE, cur)
            synced = j.synced
            wt = mts.submit_commit(writer, commits)
            sub = read_round(mts, store.graph.n_versions, fresh)
            fresh = [int(v) for v in mts.results(writer, wt, timeout=600)]
            if fresh != list(range(lo, lo + WRITE_WAVE)) \
                    or j.synced != synced + 1:
                raise AssertionError(f"write wave {fresh}: "
                                     f"{j.synced - synced} fsyncs")
            acked += fresh
            write_waves += 1
            checked += collect(mts, sub)
        checked += collect(mts, read_round(mts, store.graph.n_versions,
                                           fresh))
        journals.append((j.write_s, j.synced))
        # 5. kill: the servers close without a snapshot
        mts.close()
        launches1 = launch_counts()                   # window 1 closes
        # the servers' counters, folded up to the coordinator's: every
        # ticket id a client was handed before the kill is below them
        marks = {t: s._next_ticket for t, s in mts.tenant_servers().items()}
        stats1 = {t: dataclasses.asdict(mts.stats(t)) for t in tenants}
        lat1 = {t: {"p50_ms": 1e3 * s.stats.p50_latency_s,
                    "max_ms": 1e3 * s.stats.max_latency_s}
                for t, s in mts.tenant_servers().items()}
        grants1 = list(mts.grant_log)
        jain1 = jain_index(list(durable_window(grants1, readers).values()))
        live = types.SimpleNamespace(
            epoch=store.epoch, assignment=store.assignment.copy(),
            data=store.data, graph=types.SimpleNamespace(
                indptr=store.graph.indptr.copy(),
                indices=store.graph.indices.copy()))
        n_live = store.graph.n_versions
        if acked != list(range(n0, n_live)) or n_live != n0 + 6 * WRITE_WAVE:
            raise AssertionError(f"acknowledged {len(acked)} versions, the "
                                 f"store holds {n_live}")
        head_path = dur.journal.path
        dead = weakref.ref(store)
        del mts, store, dur, j, sub
        opened.clear()
        gc.collect()
        torch.cuda.empty_cache()
        leaked = torch.cuda.memory_allocated() - mem0
        if dead() is not None or leaked:
            raise AssertionError(f"the killed store is still referenced "
                                 f"({dead() is not None}) or {leaked} bytes "
                                 "are still allocated on the card")
        # 6. restore, timed in its parts
        replay_s = [0.0]
        real_replay = dmod.replay_into

        def timed_replay(s, recs):
            t0 = time.perf_counter()
            try:
                return real_replay(s, recs)
            finally:
                replay_s[0] += time.perf_counter() - t0

        zero_launch_counts()                          # window 2 opens
        dmod.replay_into = timed_replay
        try:
            t = time.perf_counter()
            dur = StoreDurability(root)
            rs = dur.restore(device=DEVICE)
            restore_s = time.perf_counter() - t
        finally:
            dmod.replay_into = real_replay
        store = rs.store
        head, bad = read_records(head_path)
        n_data = sum(r.kind == "commit.batch" for r in head)
        if (rs.snapshot.vid != snap2.vid or bad is not None
                or rs.replayed != len(head) or n_data != 2):
            raise AssertionError(f"restore replayed {rs.replayed} records "
                                 f"of the {len(head)} after snapshot 2 "
                                 f"({n_data} data)")
        if not snapshot_roundtrip_equal(store, live) \
                or store.epoch != live.epoch:
            raise AssertionError("the restored store differs from the "
                                 "store at the kill")
        if (store.device != torch.device(DEVICE)
                or peek_superblock(store) is not None):
            raise AssertionError("restore pinned a superblock or left the "
                                 "card")
        low = {t: (rs.ticket_watermarks.get(t, 0), marks[t])
               for t in tenants if rs.ticket_watermarks.get(t, 0) < marks[t]}
        if low:
            raise AssertionError(f"restored watermarks below the kill's: "
                                 f"{low}")
        mts = make_mts(store)
        resume_tickets(mts, rs.ticket_watermarks)
        # 7. serve the restored store: the first batch re-pins the
        # superblock
        t = time.perf_counter()
        vids = read_wave_vids(np, rng, n_live, acked[-WRITE_WAVE:])
        tks = mts.submit_many(readers[0], vids)
        first = mts.results(readers[0], tks, timeout=600)
        first_s = time.perf_counter() - t
        if min(tks) < marks[readers[0]]:
            raise AssertionError("a restored ticket id collides with a "
                                 "pre-kill one")
        checked2 = check(vids, first)
        sub_all = []
        for b in range(1, DURABLE_RESTORED_BATCHES):
            t = tenants[b % len(tenants)]
            vids = read_wave_vids(np, rng, n_live, acked[-WRITE_WAVE:])
            sub_all.append((t, vids, mts.submit_many(t, vids)))
        for t, vids, tks in sub_all:
            checked2 += check(vids, mts.results(t, tks, timeout=600))
        # 8. continue: the last commits, a journaled migration, 4 batches
        hi = w.n_versions
        commits, cur = commit_wave(w, tree, n_live, hi, cur)
        j = get_journal(store)
        synced = j.synced
        got = [int(v) for v in mts.results(
            writer, mts.submit_commit(writer, commits), timeout=600)]
        if got != list(range(n_live, hi)) or j.synced != synced + 1:
            raise AssertionError(f"restored store's write wave gave {got}")
        if not mts.drain(timeout=600):
            raise AssertionError("the tenants did not drain")
        t = time.perf_counter()
        assignment = lyresplit_for_budget(tree, 2 * w.n_records
                                          ).best.assignment
        mplan = plan_migration(store, assignment)
        old_sb = take_superblock(store)
        store.apply_migration(mplan)
        _, mstats = migrate_superblock(store, old_sb, mplan)
        migration_s = time.perf_counter() - t
        recs, _ = read_records(head_path)
        if [r.kind for r in recs[len(head):] if r.kind != "ticket"] != \
                ["commit.batch", "migration.intent", "migration.commit"]:
            raise AssertionError("the restored store did not journal its "
                                 "commit wave and migration")
        for _ in range(4):
            sub = read_round(mts, hi, list(range(n_live, hi)))
            checked2 += collect(mts, sub)
        mts.close()
        launches2 = launch_counts()                   # window 2 closes
        lat2 = {t: {"p50_ms": 1e3 * s.stats.p50_latency_s,
                    "max_ms": 1e3 * s.stats.max_latency_s}
                for t, s in mts.tenant_servers().items()}
        jain2 = jain_index(list(durable_window(list(mts.grant_log),
                                               readers).values()))
        if not (np.array_equal(store.graph.indptr, w.graph.indptr)
                and np.array_equal(store.graph.indices, w.graph.indices)):
            raise AssertionError("the restored store's CSR differs from "
                                 "the workload's")
        # 9. scrub
        t = time.perf_counter()
        scrub = dur.scrub()
        scrub_s = time.perf_counter() - t
        findings = sum(len(b) for b in scrub["snapshots"].values()) + sum(
            j_["bad_offset"] is not None for j_ in scrub["journals"].values())
        if not scrub["clean"] or findings:
            raise AssertionError(f"scrub found {findings}: {scrub}")
        # 10. launch counts
        others = {k: n for k, n in {**launches1, **launches2}.items()
                  if n and k not in ("checkout_wave", "segment_append",
                                     "segment_move")}
        if (launches1["checkout_wave"] <= 0
                or launches2["checkout_wave"] <= 0
                or launches1["segment_append"] != write_waves
                or launches2["segment_append"] != 1
                or launches1["segment_move"] != 0
                or launches2["segment_move"] != 1 or others):
            raise AssertionError(f"durable launches off: before the kill "
                                 f"{launches1}, after {launches2}")
        if mstats is None or not mstats.used_device:
            raise AssertionError(f"the migration did not run on the card: "
                                 f"{mstats}")
        write_s = sum(a for a, _ in journals)
        synced_n = sum(b for _, b in journals)
        shed = sum(s["shed_overload"] + s["shed_quota"]
                   for s in stats1.values())
        out.update({
            "versions": w.n_versions, "records": w.n_records,
            "write_waves_before_kill": write_waves,
            "acknowledged_versions": len(acked),
            "tickets_before_kill": checked, "tickets_after_restore": checked2,
            "fsync_ms_per_wave": 1e3 * write_s / synced_n,
            "journal_write_s": write_s, "journal_synced": synced_n,
            "restore_s": restore_s, "replay_s": replay_s[0],
            "read_verify_s": restore_s - replay_s[0],
            "first_batch_s": first_s, "replayed": rs.replayed,
            "migration_s": migration_s, "scrub_s": scrub_s,
            "latency_before_kill": lat1, "latency_after_restore": lat2,
            "jain_before_kill": jain1, "jain_after_restore": jain2,
            "grants_before_kill": len(grants1), "sheds": shed,
            "tenant_stats_before_kill": stats1,
            "launches_before_kill": launches1,
            "launches_after_restore": launches2,
            "watermarks": {"restored": rs.ticket_watermarks,
                           "at_kill": marks}})
        report["durable"] = out
        print(f"durable path: {len(acked)} versions in {write_waves} "
              f"acknowledged write waves (one fsync each, "
              f"{out['fsync_ms_per_wave']:.2f} ms a wave on the host clock, "
              f"{gpu}), the faulted wave "
              f"left no trace; {checked} tickets before the kill and "
              f"{checked2} after restore bit-identical; launches "
              f"{launches1} then {launches2}; scrub clean")
        print(f"restore (host clock): read + verify "
              f"{out['read_verify_s']:.2f} s, replay of {rs.replayed} "
              f"records {out['replay_s']:.2f} s, first batch (re-pin) "
              f"{first_s:.2f} s; migration {migration_s:.2f} s; scrub "
              f"{scrub_s:.2f} s; {gpu}")
        print("tenant ticket latency p50/max ms (host clock, grant to "
              "delivery): " + ", ".join(
                  f"{t} {lat1[t]['p50_ms']:.1f}/{lat1[t]['max_ms']:.1f} then "
                  f"{lat2[t]['p50_ms']:.1f}/{lat2[t]['max_ms']:.1f}"
                  for t in tenants)
              + f"; Jain {jain1:.4f} then {jain2:.4f} over the readers' "
              f"contention window; {len(grants1)} grants, {shed} sheds "
              f"before the kill; {gpu}")
    finally:
        for mts in opened:
            mts.close(drain=False)
        shutil.rmtree(root, ignore_errors=True)


def host_batches(np, rows, seq_len: int, global_batch: int, seed: int,
                 n_steps: int) -> list:
    """The dataset's batch order computed from host rows: sequences of
    ``seq_len + 1`` tokens, a seeded permutation per epoch, the tail
    wrapped (no dropped hosts)."""
    flat = rows.reshape(-1)
    chunk = seq_len + 1
    n = len(flat) // chunk
    seqs = flat[:n * chunk].reshape(n, chunk).astype(np.int32)
    order = np.random.default_rng(seed).permutation(n)
    per_epoch = max(n // global_batch, 1)
    out = []
    for step in range(n_steps):
        epoch, i = divmod(step, per_epoch)
        if i == 0 and step > 0:
            order = np.random.default_rng(seed + epoch).permutation(n)
        idx = order[i * global_batch:(i + 1) * global_batch]
        if len(idx) < global_batch:
            idx = np.concatenate([idx, order[:global_batch - len(idx)]])
        out.append(seqs[idx])
    return out


def phase_dataset(torch, np, store, seed: int, report: dict) -> list:
    """The dataset path at full width: a ``VersionedDataset`` over the
    read phase's SCI_1M store checks out ``DATASET_VERSIONS`` seeded
    versions through ``gather_row_tiles``, ``DATASET_UNTILED`` of them again
    through ``gather_rows``, 8 of them as one ``checkout_many`` wave, and
    streams 8 batches of 32 sequences from ``DATASET_STREAMS`` of them.
    Every result is checked bit for bit: against the partition block's
    sorted local rows and the record pool's ``data[rlist(v)]`` (the same
    order, so also the same set), and the batches against the same
    generator run on those host rows.  Returns the vids."""
    from repro_torch.data import VersionedDataset
    ds = VersionedDataset(store=store, seq_len=DATASET_SEQ_LEN)
    rng = np.random.default_rng(seed + 3)
    vids = [int(v) for v in rng.choice(store.graph.n_versions,
                                       DATASET_VERSIONS, replace=False)]

    def want_rows(v):
        p = store.partitions[store.vid_to_pid[v]]
        want = p.block[np.sort(p.local_rlist(v))]
        if not np.array_equal(want, store.data[store.graph.rlist(v)]):
            raise AssertionError(f"partition rows of version {v} differ "
                                 "from data[rlist(v)]")
        return want

    def check(rows, v, how):
        if rows.dtype != store.data.dtype or \
                not np.array_equal(rows, want_rows(v)):
            raise AssertionError(f"{how} checkout of version {v} differs "
                                 "from data[rlist(v)]")

    tiled_ms, untiled_ms = [], []
    zero_launch_counts()                      # the dataset path's window
    for v in vids:
        t = time.perf_counter()
        rows = ds.checkout(v)
        tiled_ms.append(1e3 * (time.perf_counter() - t))
        check(rows, v, "tiled")
    for v in vids[:DATASET_UNTILED]:
        t = time.perf_counter()
        rows = ds.checkout(v, use_tiled=False)
        untiled_ms.append(1e3 * (time.perf_counter() - t))
        check(rows, v, "untiled")
    for rows, v in zip(ds.checkout_many(vids[:8]), vids[:8]):
        check(rows, v, "checkout_many")
    steps = 0
    for v in vids[:DATASET_STREAMS]:
        want = host_batches(np, want_rows(v), ds.seq_len, 32, seed, 8)
        for b, w in zip(ds.batches(v, global_batch=32, seed=seed,
                                   n_steps=8), want):
            if not (np.array_equal(b["tokens"], w[:, :-1])
                    and np.array_equal(b["labels"], w[:, 1:])
                    and b["tokens"].shape == (32, ds.seq_len)):
                raise AssertionError(f"batch {b['step']} of version {v} "
                                     "differs from the host generator")
            steps += 1
    launches = launch_counts()                # the window closes
    sizes = store.graph.version_sizes()
    nonempty = [int(sizes[v] > 0) for v in vids]
    want = {"gather_row_tiles": sum(nonempty)
            + sum(nonempty[:DATASET_STREAMS]),
            "gather_rows": sum(nonempty[:DATASET_UNTILED]),
            "checkout_wave": launches["checkout_wave"] or 1}   # the wave: >= 1
    if steps != 8 * DATASET_STREAMS or any(
            launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"dataset path launches {launches}, "
                             f"expected {want}, {steps} batches")
    report["dataset"] = {
        "versions": vids, "records": [int(sizes[v]) for v in vids],
        "launches": launches, "batches": steps,
        "checkout_tiled_host_ms": tiled_ms,
        "checkout_untiled_host_ms": untiled_ms}
    print(f"dataset: {DATASET_VERSIONS} tiled and {DATASET_UNTILED} "
          f"untiled checkouts, a checkout_many wave of 8 and "
          f"{steps} batches bit-identical; launches={launches}; a checkout "
          f"{np.mean(tiled_ms):.2f} ms tiled, {np.mean(untiled_ms):.2f} ms "
          f"untiled (host clock, mean; "
          f"{np.mean([sizes[v] for v in vids]):.0f} records a version)")
    return vids


def sum_rtol(r: int) -> float:
    """The float32 sum's relative error bound in ``version_aggregate``'s
    CUDA kernel, for nonnegative values (for signed ones, of the sum of the
    terms' absolute values).  Derived from its summation order: each of a
    chunk's ``CHUNK_ROWS`` / 16 tensor-core accumulates into the hi, mid and
    lo columns counts as off by up to 2^-23 of the running sum (the ``mma``
    accumulation is not promised to round to nearest; the products with
    0/1 bits are exact, and every column's running sum is at most the
    version's total); then two float32 adds, (hi + mid) + lo, and in the
    second pass ceil(chunks / 8) partials in order in each of 8 warps and
    the 8 warp sums in order, each add off by at most 2^-24 of the sum so
    far.  ``block_r`` does not enter: on the card it sets no order."""
    from repro_torch.kernels.version_agg import CHUNK_ROWS
    chunks = -(-r // CHUNK_ROWS)
    return ((CHUNK_ROWS // 16) * 2.0 ** -23
            + (2 + -(-chunks // 8) + 8) * 2.0 ** -24)


def phase_analytics(torch, np, store, seed: int, report: dict) -> dict:
    """The analytics path at full width over the store's bitset vlists
    (built on the host, uploaded once): per-version sizes (values of ones),
    the count of records with col2 > 900 and the sum of col3, through
    ``version_aggregate`` on the row-major tensor; ``SCAN_VERSIONS``
    seeded versions' ``membership_scan`` on its word-major copy, made once
    after the upload (its time is ``word_major_ms``), all through the
    kernel's vec4 instance; then the same scans again outside the window
    on both layouts in turns, on the host clock.  Sizes and counts must
    equal the CSR and the
    port's ``core.query.per_version_aggregate`` exactly; the sum must match
    its float64 result within ``sum_rtol``; every mask must equal the CSR
    membership and its counts the version's size.  Returns the kernel
    inputs for the timing phase."""
    from repro_torch.core.query import per_version_aggregate
    from repro_torch.kernels import ops
    from repro_torch.kernels import vlist_membership as vm
    graph, data = store.graph, store.data
    n, r = graph.n_versions, graph.n_records
    t = time.perf_counter()
    bm = ops.build_bitmap(graph.rlists(), r)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    words = ops.as_bitmap(bm, store.device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    words_wm = ops.word_major(words)          # made once, read by the scans
    end.record()
    end.synchronize()
    word_major_ms = start.elapsed_time(end)
    queries = {"sizes": np.ones(r, np.float32),
               "count_col2_gt_900": (data[:, 2] > 900).astype(np.float32),
               "sum_col3": data[:, 3].astype(np.float32)}
    rng = np.random.default_rng(seed + 4)
    scan_vids = [int(v) for v in rng.choice(n, SCAN_VERSIONS, replace=False)]
    zero_launch_counts()                      # the analytics path's window
    t = time.perf_counter()
    sums = {k: ops.version_aggregate(words, v).cpu().numpy()
            for k, v in queries.items()}
    agg_ms = 1e3 * (time.perf_counter() - t) / len(queries)
    t = time.perf_counter()
    scans = {v: tuple(x.cpu().numpy()
                      for x in ops.membership_scan(words_wm, v))
             for v in scan_vids}
    scan_ms = 1e3 * (time.perf_counter() - t) / len(scan_vids)
    launches = launch_counts()                # the window closes
    want = {"version_aggregate": len(queries),
            "membership_scan": len(scan_vids)}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"analytics path launches {launches}, "
                             f"expected {want}")
    # the same scans again, outside the window, on each layout in turn
    # (row-major, word-major, word-major, row-major): what the layout alone
    # costs on the host clock, in one process
    turns: dict = {"row_major": [], "word_major": []}
    for name in ("row_major", "word_major", "word_major", "row_major"):
        x = words if name == "row_major" else words_wm
        t = time.perf_counter()
        for v in scan_vids:
            for y in ops.membership_scan(x, v):
                y.cpu().numpy()
        turns[name].append(1e3 * (time.perf_counter() - t) / len(scan_vids))
    instances = {vm.instance(words_wm, v, min(vm.DEFAULT_BR, max(8, r)))
                 for v in scan_vids}
    if instances != {"vec4"}:
        raise AssertionError(f"the analytics path's scans ran {instances}, "
                             "not the vec4 instance")
    t = time.perf_counter()
    ref_count = per_version_aggregate(graph, data, 2, "count",
                                      predicate=lambda d: d[:, 2] > 900)
    ref_sum = per_version_aggregate(graph, data, 3, "sum")
    query_s = time.perf_counter() - t
    sizes = graph.version_sizes()
    if any(s[n:].any() for s in sums.values()):
        raise AssertionError("a sum past the last version is not 0")
    if not np.array_equal(sums["sizes"][:n], sizes):
        raise AssertionError("version_aggregate of ones != version sizes")
    if not np.array_equal(sums["count_col2_gt_900"][:n], ref_count):
        raise AssertionError("count(col2 > 900) != per_version_aggregate")
    if data[:, 3].min() < 0:
        raise AssertionError("sum_rtol holds for nonnegative values only")
    rtol = sum_rtol(r)
    rel = np.abs(sums["sum_col3"][:n] - ref_sum) / np.maximum(ref_sum, 1)
    if not (rel <= rtol).all():
        raise AssertionError(f"sum(col3) off by {rel.max():.3g} (relative),"
                             f" above the bound {rtol:.3g}")
    for v, (mask, cnt) in scans.items():
        want_m = np.zeros(r, np.int32)
        want_m[graph.rlist(v)] = 1
        want_c = np.pad(want_m, (0, (-r) % 1024)).reshape(-1, 1024).sum(1)
        if not (np.array_equal(mask, want_m) and np.array_equal(cnt, want_c)
                and int(cnt.sum()) == sizes[v]):
            raise AssertionError(f"membership_scan of version {v} differs "
                                 "from the CSR")
    report["analytics"] = {
        "bitmap_shape": list(bm.shape), "bitmap_bytes": int(bm.nbytes),
        "build_bitmap_s": build_s, "upload_s": upload_s,
        "word_major_ms": word_major_ms,
        "launches": launches, "scan_versions": scan_vids,
        "aggregate_host_ms": agg_ms, "scan_host_ms": scan_ms,
        "scan_host_ms_turns": turns,
        "numpy_query_s": query_s, "sum_rel_err_max": float(rel.max()),
        "sum_rtol": rtol}
    print(f"analytics: bitmap {bm.shape} ({bm.nbytes / 1e6:.0f} MB, built "
          f"in {build_s:.2f} s, uploaded in {1e3 * upload_s:.0f} ms, its "
          f"word-major copy made in {word_major_ms:.4f} ms); sizes "
          f"and count(col2>900) exact, sum(col3) within {rel.max():.2g} "
          f"(bound {rtol:.2g}), {len(scan_vids)} membership scans of the "
          f"word-major view exact (vec4); "
          f"launches={launches}; {agg_ms:.2f} ms an aggregate, "
          f"{scan_ms:.2f} ms a scan (host clock, with the D2H copy); the "
          f"scans again in turns, row-major "
          f"{'/'.join(f'{x:.3f}' for x in turns['row_major'])} ms and "
          f"word-major {'/'.join(f'{x:.3f}' for x in turns['word_major'])}"
          f" ms")
    return {"words": words, "words_wm": words_wm, "values": queries,
            "vid": scan_vids[0]}


def aggregate_design_floor(torch, r: int, w: int) -> dict:
    """The least time of ``version_aggregate``'s tensor-core design (as
    against the function's own bound): its bytes (the bitmap and values
    once, the outputs, and the per-chunk partials written and read), its
    ``mma`` count (2 a word per 16-row K-step, the chunks padded to 64-row
    stages) at the bf16 peak, and its warp instructions at the card's peak
    issue rate (4 a clock on each SM at the maximum SM clock nvidia-smi
    reports): 10 of bit expansion (4 shifts, 8 prmt, 8 and per word and
    K-step) and the mma itself, per mma."""
    from repro_torch.kernels.version_agg import CHUNK_ROWS
    chunks = -(-r // CHUNK_ROWS)
    last = r - (chunks - 1) * CHUNK_ROWS
    ksteps = 4 * ((chunks - 1) * (CHUNK_ROWS // 64) + -(-last // 64))
    mma = 2 * w * ksteps
    partial_bytes = 2 * 4 * chunks * 32 * w
    design_bytes = 4 * r * w + 4 * r + 128 * w + partial_bytes
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        mhz = float("nan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = 4 * sms * mhz * 1e6
    out = {"chunk_rows": CHUNK_ROWS, "chunks": chunks,
           "partial_bytes": partial_bytes, "bytes": design_bytes,
           "mma": mma, "expand_warp_instr": 10 * mma,
           "sm_clock_max_mhz": mhz, "sms": sms,
           "bytes_ms": 1e3 * design_bytes / HBM_BYTES_PER_S,
           "mma_ms": 1e3 * mma * 2 * 16 * 8 * 16 / BF16_OPS_PER_S,
           "issue_ms": 1e3 * 11 * mma / issue_per_s}
    out["floor_ms"] = max(out["bytes_ms"], out["mma_ms"], out["issue_ms"])
    return out


def phase_dataset_analytics_timing(torch, np, store, vids, inputs: dict,
                                   report: dict) -> dict:
    """The four kernels of the dataset and analytics paths at their
    shapes, each against its plain version on the same device inputs
    (outside the paths' launch windows), with ``queued_ms`` and a cold L2:
    the gathers over the first 8 dataset versions (mean), after the parts
    of a checkout (block upload as the path makes it, pageable; lane and
    row pad; device-to-host copy of the packed rows); the bitmap kernels
    on the analytics path's bitmap."""
    from repro_torch.kernels import checkout_gather as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels import version_agg as va
    from repro_torch.kernels import vlist_membership as vm
    # a read of 128 MB (over twice the L2) evicts the inputs and leaves no
    # dirty lines for the timed kernel to write back
    flush_buf = torch.zeros(32 << 20, dtype=torch.int32,
                            device=inputs["words"].device)
    flush = flush_buf.sum
    bn = cg.DEFAULT_BN
    rows_t: dict = {"gather_row_tiles": [], "gather_rows": []}
    parts = []
    for v in vids[:8]:
        p = store.partitions[store.vid_to_pid[v]]
        rl = np.sort(p.local_rlist(v))
        t = time.perf_counter()
        tiles, _, waste = ops.plan_tiles(rl)
        plan_ms = 1e3 * (time.perf_counter() - t)
        block = torch.from_numpy(p.block).cuda()
        d = block.shape[1]
        bd = min(cg.DEFAULT_BD, max(128, d))

        def pad(block=block, bd=bd):
            return ops._pad_axis(ops._pad_axis(block, bd, axis=1), bn,
                                 axis=0).contiguous()

        padded = pad()
        row_bytes = padded.shape[1] * padded.element_size()
        fill = np.full((-len(rl)) % bn, rl[0], np.int32)
        rids = torch.from_numpy(np.concatenate([rl.astype(np.int32), fill]
                                               )).cuda()
        idx = torch.from_numpy(tiles).cuda()
        t_tiles, n_row_tiles = len(tiles), len(rids) // bn
        tiled = cg._launch("gather_row_tiles", padded, idx, t_tiles, bn)
        parts.append({
            "version": v, "records": len(rl), "tiles": t_tiles,
            "waste": waste, "block_bytes": int(p.block.nbytes),
            "plan_tiles_host_ms": plan_ms,
            "upload_ms": cuda_ms(torch, lambda p=p: torch.from_numpy(
                p.block).cuda(), 3),
            "pad_ms": cuda_ms(torch, pad, 3),
            "d2h_ms": cuda_ms(torch, lambda x=tiled: x.cpu(), 3)})
        tile_view = padded.view(-1, bn * padded.shape[1])
        for name, idx_d, n_tiles, plain, lib_src, reads, out_rows in (
                ("gather_row_tiles", idx, t_tiles,
                 lambda x=padded, i=idx: cg.gather_row_tiles_plain(x, i),
                 tile_view, t_tiles * bn, t_tiles * bn),
                ("gather_rows", rids, n_row_tiles,
                 lambda x=padded, i=rids: cg.gather_rows_plain(x, i),
                 padded, len(rl), len(rids))):
            got = cg._launch(name, padded, idx_d, n_tiles, bn)
            want = plain()
            if not torch.equal(got, want):
                raise AssertionError(f"full-size {name} != plain")
            del got, want
            idx_long = idx_d.long()
            bytes_min = (reads + out_rows) * row_bytes + 4 * idx_d.numel()
            rows_t[name].append({
                "bytes_min": bytes_min, "max_abs_err": 0,
                "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
                "ms": queued_ms(torch, lambda a=(name, padded, idx_d,
                                                 n_tiles, bn):
                                cg._launch(*a), 20, flush),
                "plain_ms": queued_ms(torch, plain, 10, flush),
                "library_ms": queued_ms(
                    torch, lambda s=lib_src, i=idx_long: torch.index_select(
                        s, 0, i), 20, flush)})
        del block, padded, tiled, tile_view
    out = {name: {k: (max if k == "max_abs_err" else np.mean)(
        [x[k] for x in xs]) for k in xs[0]} for name, xs in rows_t.items()}
    out = {name: {k: v if k == "max_abs_err" else float(v)
                  for k, v in o.items()} for name, o in out.items()}
    checkout = {k: float(np.mean([x[k] for x in parts]))
                for k in parts[0] if k != "version"}

    words, words_wm = inputs["words"], inputs["words_wm"]
    vid = inputs["vid"]
    r, w = words.shape
    word = vid // 32
    n_blocks = -(-r // 1024)
    # row-major, each row's word costs the 32-byte sector it lies in;
    # word-major, the version's words are one 4R-byte run
    sectors = int(np.unique((np.arange(r, dtype=np.int64) * w + word)
                            * 4 // 32).size)
    for key, label, x, bytes_min, want_i in (
            ("membership_scan_row_major", "strided row-major", words,
             32 * sectors + 4 * r + 4 * n_blocks, "strided"),
            ("membership_scan", "vec4 word-major", words_wm,
             4 * r + 4 * r + 4 * n_blocks, "vec4")):
        mask, cnt = vm._launch(x, vid, 1024)
        want_m, want_c = vm.membership_scan_plain(x, vid, block_r=1024)
        if not (torch.equal(mask, want_m) and torch.equal(cnt, want_c)
                and vm.instance(x, vid, 1024) == want_i):
            raise AssertionError(f"full-size {key} != plain, or not "
                                 f"{want_i}")
        out[key] = {
            "label": f"membership_scan {label}",
            "bytes_min": bytes_min, "max_abs_err": 0,
            "bound_ms": 1e3 * bytes_min / HBM_BYTES_PER_S,
            "ms": queued_ms(torch, lambda x=x: vm._launch(x, vid, 1024), 20,
                            flush),
            "plain_ms": queued_ms(
                torch, lambda x=x: vm.membership_scan_plain(
                    x, vid, block_r=1024), 10, flush),
            "library_ms": None}
    out["membership_scan_row_major"]["sectors"] = sectors
    # the same launch over one count block: what a launch costs whatever R
    out["membership_scan"]["one_block_ms"] = queued_ms(
        torch, lambda: vm._launch(words_wm[:1024], vid, 1024), 20, flush)
    del mask, cnt, want_m, want_c
    copy_bytes = 2 * 4 * r * w
    copy = {"bytes_min": copy_bytes,
            "bound_ms": 1e3 * copy_bytes / HBM_BYTES_PER_S,
            "ms": queued_ms(torch, lambda: ops.word_major(words), 5, flush)}
    gain = (out["membership_scan_row_major"]["ms"]
            - out["membership_scan"]["ms"])
    copy["break_even_scans"] = copy["ms"] / gain if gain > 0 else None
    report["word_major_copy"] = copy
    err = 0.0
    for name, values in inputs["values"].items():
        vals = torch.from_numpy(values).cuda()
        got = va._launch(words, vals, 1024)
        want = va.version_aggregate_plain(words, vals)
        tol = sum_rtol(r) * want.abs()
        diff = (got - want).abs()
        if not (diff <= tol).all():
            raise AssertionError(f"full-size version_aggregate != plain "
                                 f"({name}: max abs err "
                                 f"{float(diff.max())})")
        err = max(err, float(diff.max()))
    agg_bytes = 4 * r * w + 4 * r + 128 * w
    agg_ops = 2 * 32 * r * w
    bytes_ms = 1e3 * agg_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * agg_ops / FP32_OPS_PER_S
    out["version_aggregate"] = {
        "bytes_min": agg_bytes, "operations": agg_ops, "max_abs_err": err,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "design": aggregate_design_floor(torch, r, w),
        "ms": queued_ms(torch, lambda: va._launch(words, vals, 1024), 20,
                        flush),
        "plain_ms": queued_ms(torch, lambda: va.version_aggregate_plain(
            words, vals), 3, flush),
        "library_ms": None}
    del flush_buf
    torch.cuda.synchronize()
    report["dataset_analytics_timing"] = out
    report["checkout_parts"] = checkout
    for name, o in out.items():
        lib = ("no single torch call" if o["library_ms"] is None
               else f"index_select {o['library_ms']:.4f} ms")
        print(f"{o.get('label', name)} ({o['bytes_min'] / 1e6:.1f} MB): "
              f"kernel "
              f"{o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, {lib}, "
              f"bound {o['bound_ms']:.4f} ms")
    print(f"membership_scan vec4 over one block of 1024 rows: "
          f"{out['membership_scan']['one_block_ms']:.4f} ms")
    even = copy["break_even_scans"]
    print(f"word_major copy ({copy['bytes_min'] / 1e6:.1f} MB read and "
          f"written): {copy['ms']:.4f} ms, bound "
          f"{copy['bound_ms']:.4f} ms; it pays for itself after "
          f"{'no number of' if even is None else f'{even:.2f}'} scans")
    d = out["version_aggregate"]["design"]
    print(f"version_aggregate design floor: {d['floor_ms']:.4f} ms = max("
          f"bytes {d['bytes'] / 1e6:.1f} MB with {d['chunks']} chunks' "
          f"partials {d['bytes_ms']:.4f} ms, {d['mma']} mma "
          f"{d['mma_ms']:.4f} ms, {11 * d['mma'] / 1e6:.1f} M warp "
          f"instructions at {d['sms']} SMs x 4 x {d['sm_clock_max_mhz']:.0f}"
          f" MHz {d['issue_ms']:.4f} ms)")
    print(f"a tiled checkout's parts (mean of 8): block upload "
          f"{checkout['block_bytes'] / 1e6:.1f} MB pageable "
          f"{checkout['upload_ms']:.3f} ms, pad {checkout['pad_ms']:.3f} ms, "
          f"kernel {out['gather_row_tiles']['ms']:.4f} ms, D2H "
          f"{checkout['d2h_ms']:.3f} ms, plan_tiles on the host "
          f"{checkout['plan_tiles_host_ms']:.3f} ms")
    return out


def trace_device_time(prof, label: str) -> tuple:
    """(device busy ms, [(op, device ms, launches)] largest first) of a
    torch.profiler run, read off its trace (written to
    chiprun_out/chip_smoke_trace_<label>.json): busy is the union of the
    kernel, copy and memset intervals."""
    out = ROOT / "chiprun_out" / f"chip_smoke_trace_{label}.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, cur = 0.0, None          # union of device intervals
    by_op: dict = {}
    for s0, s1, name in dev:
        ms, n = by_op.get(name, (0.0, 0))
        by_op[name] = (ms + (s1 - s0) / 1e3, n + 1)
        if cur is None or s0 > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s0, s1]
        else:
            cur[1] = max(cur[1], s1)
    busy_ms = (busy_us + cur[1] - cur[0]) / 1e3
    return busy_ms, sorted(((name, ms, n) for name, (ms, n) in by_op.items()),
                           key=lambda row: -row[1])


def phase_profile(torch, store, waves, report: dict, label: str) -> None:
    """Device busy share and device time by op over served waves, read off
    a torch.profiler trace (written to chiprun_out/chip_smoke_trace_<label>
    .json).  Fresh traffic plans every wave on the host; traffic served
    again hits the plan memo."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import BatchedCheckoutServer
    srv = BatchedCheckoutServer(store, pipeline=True)
    srv.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for vids in waves:
            srv.submit_many(vids)
            srv.flush()
        srv.deliver()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    srv.close()
    busy_ms, rows = trace_device_time(prof, label)
    report[f"profile_{label}"] = {"waves": len(waves), "wall_ms": wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_busy_share": busy_ms / wall_ms,
                         "device_ms_by_op": rows}
    print(f"profile ({label}): {len(waves)} waves in {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms, _ in rows:
        print(f"  {ms:9.3f} ms  {name[:90]}")


def _close_err(got, want, tol: float) -> tuple:
    """(allclose at atol = rtol = ``tol``, max abs error), in float32."""
    diff = (got.float() - want.float()).abs()
    return (bool((diff <= tol + tol * want.float().abs()).all()),
            float(diff.max()))


def flash_cases(torch):
    """(B, Sq, Sk, H, Hkv, Dqk, Dv, causal, dtype): GQA groups 1, 2, 4 and 3
    and MQA; Dh 16, 32, 64, 80 and 128 (bf16: the wgmma instance), 72, 192
    and 256 (bf16: the mma.sync instance), and latent attention's
    (192, 128) (bf16: the wgmma instance; causal and not, GQA, a ragged S
    of 333 and Sq != Sk); S from 128 to 4096 + 77, and lengths off the
    128- and 64-row tiles (200, 4173, 130, 300 against Sk 136, 333, and
    Sk 192 against Sq 128); causal and not; float32 and bfloat16."""
    shapes = [(2, 128, 128, 4, 4, 16, True), (1, 256, 256, 8, 4, 64, False),
              (2, 512, 512, 8, 2, 80, True), (1, 1024, 1024, 4, 1, 128, True),
              (1, 384, 384, 6, 2, 80, False), (1, 200, 200, 4, 2, 64, True),
              (1, 128, 192, 4, 4, 32, False), (1, 4173, 4173, 2, 1, 80, True),
              (2, 300, 136, 4, 2, 64, False), (1, 200, 200, 8, 2, 128, True),
              (1, 130, 130, 4, 2, 72, True), (1, 384, 384, 2, 2, 256, True),
              (1, 512, 512, 4, 4, 192, True), (2, 333, 333, 2, 2, 192, True)]
    cases = [(b, sq, sk, h, hkv, d, d, c) for b, sq, sk, h, hkv, d, c in shapes]
    cases += [(1, 512, 512, 4, 4, 192, 128, True),
              (2, 333, 333, 4, 2, 192, 128, True),
              (1, 256, 256, 4, 1, 192, 128, False),
              (2, 200, 328, 2, 2, 192, 128, False)]
    return [c + (dt,) for c in cases for dt in (torch.float32, torch.bfloat16)]


def ssd_cases(torch):
    """(B, L, H, P, N, chunk, dtype): chunk 16, 64 and 256 (1 and 16
    chunks of 256); N 16, 64 and 128; P 16 and 64; float32 and
    bfloat16."""
    shapes = [(2, 128, 4, 16, 16, 16), (1, 256, 3, 64, 64, 64),
              (2, 256, 2, 64, 128, 256), (1, 512, 2, 16, 128, 64),
              (1, 4096, 2, 64, 64, 256), (1, 4096, 2, 64, 128, 256)]
    return [s + (dt,) for s in shapes
            for dt in (torch.float32, torch.bfloat16)]


def phase_model_small(torch, report: dict) -> None:
    """The two model kernels against their plain versions on hand-made
    inputs (allclose at the reference's tolerance per dtype; every flash
    instance reached, and a bf16 q that starts off a 16-byte boundary), the
    decay-about-1 SSD case in which only the carried state feeds the last
    chunks, and the operands the contract refuses: an SSD sequence that is
    not a multiple of its chunk, a head_dim of 512 and H not a multiple of
    Hkv (PlanError)."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator().manual_seed(29)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(DEVICE)

    worst: dict = {}
    instances: dict = {}
    n = 0
    for b, sq, sk, h, hkv, dh, dv, causal, dtype in flash_cases(torch):
        q = randn((b, sq, h, dh), dtype)
        k = randn((b, sk, hkv, dh), dtype)
        # a narrower v as latent attention makes it: kv[..., dn:] of rows
        # dn + dv wide, dn = dh - 64 (DeepSeek-V2's qk_nope and qk_rope)
        dn = dh - 64
        kv = randn((b, sk, hkv, dn + dv), dtype) if dv != dh else None
        v = kv[..., dn:] if dv != dh else randn((b, sk, hkv, dh), dtype)
        which = fa.instance(q, k, v)
        instances[which] = instances.get(which, 0) + 1
        if dtype == torch.bfloat16 and (dh, dv) == (192, 128) \
                and which != "wgmma":
            raise AssertionError(f"flash (192, 128) bf16 ran {which}")
        got = ops.flash_attention(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        ok, err = _close_err(got, want, FLASH_TOL[str(dtype)])
        if not ok or got.dtype != dtype or got.shape != (b, sq, h, dv):
            raise AssertionError(f"flash_attention != plain at {(b, sq, sk, h, hkv, dh, dv, causal, dtype)}: max abs err {err}")
        key = f"flash_attention {dtype}"
        worst[key] = max(worst.get(key, 0.0), err)
        n += 1
    missing = set(fa.INSTANCES.values()) - set(instances)
    if missing:
        raise AssertionError(f"no flash case reached the {sorted(missing)} "
                             f"instance(s): {instances}")
    # a q that starts 2 bytes off a 16-byte boundary: the wrapper copies
    # it, and the wgmma instance runs
    q = randn((1, 256, 4, 80), torch.bfloat16)
    k, v = (randn((1, 256, 2, 80), torch.bfloat16) for _ in range(2))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=DEVICE)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    which = fa.instance(shifted, k, v)
    got = ops.flash_attention(shifted, k, v, True)
    want = fa.flash_attention_plain(shifted, k, v, True)
    torch.cuda.synchronize()
    ok, err = _close_err(got, want, FLASH_TOL[str(q.dtype)])
    if not ok or which != "wgmma":
        raise AssertionError(f"flash_attention on a q off 16 bytes: {which} "
                             f"instance, max abs err {err}")
    worst["flash_attention torch.bfloat16"] = max(
        worst["flash_attention torch.bfloat16"], err)
    n += 1
    for b, l, h, p, nn, chunk, dtype in ssd_cases(torch):
        xs = randn((b, l, h, p), dtype)
        bm, cm = randn((b, l, nn), dtype, 0.3), randn((b, l, nn), dtype, 0.3)
        dt = torch.nn.functional.softplus(randn((b, l, h), torch.float32)
                                          ).to(dtype)
        a = -torch.exp(randn((h,), torch.float32, 0.2))
        y, st = ops.ssd_scan(xs, bm, cm, dt, a, chunk=chunk)
        y_want, st_want = ss.ssd_scan_plain(xs, bm, cm, dt, a, chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype)]
        (ok_y, err_y), (ok_s, err_s) = (_close_err(y, y_want, tol),
                                        _close_err(st, st_want, tol))
        if not (ok_y and ok_s):
            raise AssertionError(f"ssd_scan != plain at {(b, l, h, p, nn, chunk, dtype)}: max abs err y {err_y}, state {err_s}")
        key = f"ssd_scan {dtype}"
        worst[key] = max(worst.get(key, 0.0), err_y)
        n += 1
    # decay about 1, x zero past the first chunk: chunks 3-4 see only the
    # carried state (float32: the FMA instance; bf16: the state passing)
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.zeros((1, 256, 2, 32), device=DEVICE, dtype=dtype)
        xs[:, :64] = randn((1, 64, 2, 32), dtype)
        bm, cm = (randn((1, 256, 64), dtype, 0.3) for _ in range(2))
        dt = torch.full((1, 256, 2), 0.05, device=DEVICE, dtype=dtype)
        a = torch.full((2,), -0.01, device=DEVICE)
        y, _ = ops.ssd_scan(xs, bm, cm, dt, a, chunk=64)
        y_want, _ = ss.ssd_scan_plain(xs, bm, cm, dt, a, 64)
        torch.cuda.synchronize()
        ok, err = _close_err(y, y_want, 2e-4 if dtype == torch.float32
                             else SSD_TOL[str(dtype)])
        if not ok or float(y[:, 200:].float().abs().max()) <= 1e-4:
            raise AssertionError(f"ssd_scan {dtype} lost the carried state "
                                 f"(err {err})")
        n += 1
    refused = 0
    for what, fn in (
            ("H 2 over Hkv 3", lambda: ops.flash_attention(
                torch.zeros((1, 128, 2, 64), device=DEVICE),
                *([torch.zeros((1, 128, 3, 64), device=DEVICE)] * 2))),
            ("Dh = 512", lambda: ops.flash_attention(*(
                [torch.zeros((1, 128, 2, 512), device=DEVICE)] * 3))),
            ("L = 96, chunk 64", lambda: ops.ssd_scan(
                torch.zeros((1, 96, 2, 16), device=DEVICE),
                torch.zeros((1, 96, 16), device=DEVICE),
                torch.zeros((1, 96, 16), device=DEVICE),
                torch.zeros((1, 96, 2), device=DEVICE),
                torch.zeros(2, device=DEVICE), chunk=64))):
        try:
            fn()
        except build.PlanError:
            refused += 1
            continue
        raise AssertionError(f"a model kernel took {what}")
    report["model_small"] = {"cases": n, "refused": refused,
                             "max_abs_err": worst,
                             "flash_instances": instances}
    print(f"model kernels vs plain: {n} hand-made cases within tolerance "
          f"(max abs err {', '.join(f'{k} {v:.2e}' for k, v in worst.items())}), {refused} refused; flash instances {instances}")


def phase_serve(torch, seed: int, report: dict):
    """The serve path at Zamba2-2.7B's full config (54 SSD layers, d_model
    2560, the shared block applied 9 times), weights from ``init_params``
    with a seeded generator: the port's serve driver checks 4 prompts of
    512 tokens out of the CUR prompt store through the card's
    ``BatchedCheckoutServer``, fills the cache token by token (decode path,
    neither model kernel), decodes 32 tokens greedily, and runs
    ``make_prefill_step`` once on the same prompts (the path through both
    model kernels).  Checks: 9 ``flash_attention`` and 54 ``ssd_scan``
    launches, all in the prefill; the cache 543 tokens long in 544 slots;
    every logit finite; the prefill's next-token logits within the
    driver's bf16 bound of the token-by-token path's (relative L2), the
    argmax equal wherever the top-2 gap is clear of that bound.  Returns
    the model."""
    from repro_torch import configs
    from repro_torch.launch import serve as driver
    from repro_torch.models import init_params
    cfg = configs.get(MODEL_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    zero_launch_counts()                      # the serve path's window
    t0 = time.perf_counter()
    run = driver.serve(cfg, requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                       decode_steps=SERVE_DECODE, seed=seed, device=DEVICE,
                       params=model)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()                # the window closes
    res, check, cache = run["result"], run["check"], run["cache"]
    n_groups = cfg.n_layers // cfg.shared_every
    want = {"flash_attention": n_groups, "ssd_scan": cfg.n_layers}
    if (run["launches"]["prefill"] != want
            or any(run["launches"]["fill_decode"].values())
            or any(launches[k] != want[k] for k in want)):
        raise AssertionError(f"serve path launches {run['launches']}, "
                             f"expected {want} in the prefill alone")
    max_len = SERVE_PROMPT + SERVE_DECODE
    if (cache["len"] != max_len - 1 or cache["shared_k"].shape[2] != max_len):
        raise AssertionError(f"cache {cache['len']} of "
                             f"{cache['shared_k'].shape[2]} slots")
    tokens = run["tokens"]
    if not (torch.isfinite(run["fill_logits"]).all()
            and torch.isfinite(run["prefill_logits"]).all()
            and tokens.shape == (SERVE_REQUESTS, SERVE_DECODE)
            and 0 <= tokens.min() and tokens.max() < cfg.vocab):
        raise AssertionError("non-finite logits or tokens out of range")
    if not check["ok"]:
        raise AssertionError(f"prefill vs token-by-token: {check}")
    report["serve"] = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "wall_s": wall_s, "launches": run["launches"],
        "cache_len": cache["len"], "cache_slots": max_len,
        "check": check, "result": res,
        "fill_s": res["prefill_s"], "decode_s": res["decode_s"]}
    print(f"model serve: {cfg.name} ({n_params:,} params, {cfg.n_layers} SSD "
          f"layers + {n_groups} shared-block applications, d_model "
          f"{cfg.d_model}) made in {init_s:.1f} s; {SERVE_REQUESTS} requests "
          f"x {SERVE_PROMPT} prompt tokens filled token by token in "
          f"{res['prefill_s']} s, {SERVE_DECODE} greedy tokens in "
          f"{res['decode_s']} s ({res['decode_tok_per_s']} tok/s, "
          f"{res['ms_per_decode_step']:.2f} ms a step); make_prefill_step "
          f"{res['prefill_step_s']:.3f} s; launches {run['launches']}; "
          f"cache {cache['len']} of {max_len}")
    print(f"prefill vs token-by-token at position {SERVE_PROMPT - 1}: "
          f"rel L2 {[round(r, 5) for r in check['rel_l2']]} (bound "
          f"{check['bound']:.4f}), argmax agree {check['argmax_agree']}, "
          f"gap clear of the bound {check['gap_clear']}")
    print(json.dumps(res))
    return model


def phase_long_prefill(torch, model, seed: int, report: dict) -> dict:
    """The same model through ``make_prefill_step`` at B = 4, S = 4096 on
    seeded random tokens: one warm-up call that captures the inputs of the
    first shared-block attention and the first SSD layer (their kernels'
    launches pass through), then the timed call inside a launch window (9
    and 54 launches, finite logits).  Returns the captured inputs."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serve.serve_step import make_prefill_step
    cfg = configs.get(MODEL_ARCH)
    tokens = torch.randint(0, cfg.vocab, (LONG_BATCH, LONG_SEQ),
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 1), device=DEVICE)
    prefill = make_prefill_step(cfg, device=DEVICE)
    captured: dict = {}
    real = {"flash_attention": fa._launch, "ssd_scan": ss._launch}

    def capture(name):
        def launch(*args):
            if name not in captured:
                captured[name] = [x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in args]
            return real[name](*args)
        return launch

    fa._launch, ss._launch = capture("flash_attention"), capture("ssd_scan")
    try:
        prefill(model, {"tokens": tokens})
    finally:
        fa._launch, ss._launch = real["flash_attention"], real["ssd_scan"]
    torch.cuda.synchronize()
    zero_launch_counts()                      # the long prefill's window
    t0 = time.perf_counter()
    logits = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()                # the window closes
    want = {"flash_attention": cfg.n_layers // cfg.shared_every,
            "ssd_scan": cfg.n_layers}
    if any(launches[k] != want.get(k, 0) for k in launches):
        raise AssertionError(f"long prefill launches {launches}, expected "
                             f"{want}")
    if logits.shape != (LONG_BATCH, 1, cfg.vocab_padded) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("long prefill: non-finite logits or bad shape")
    report["long_prefill"] = {"batch": LONG_BATCH, "seq": LONG_SEQ,
                              "seconds": seconds, "launches": want,
                              "tokens_per_s": LONG_BATCH * LONG_SEQ / seconds}
    print(f"long prefill: B={LONG_BATCH} S={LONG_SEQ} in {seconds:.3f} s "
          f"({LONG_BATCH * LONG_SEQ / seconds:,.0f} tokens/s), launches "
          f"{want}, logits finite")
    return captured


def flash_timing(torch, q, k, v, causal: bool) -> dict:
    """``flash_attention`` on these inputs: kernel against plain version on
    the full inputs (and against the plain version's float32 result,
    before its rounding to q's dtype: how far the kernel is from exact,
    beyond that rounding), then the kernel's, the plain version's and
    ``scaled_dot_product_attention``'s times (CUDA events), the bytes
    (each input read and the output written once) and the operations (the
    (query, key) pairs the causal mask keeps, Q·Kᵀ over Dqk and P·V over
    Dv), and the design's own products (P·V twice, P as hi + lo bf16
    terms)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    got = fa._launch(q, k, v, causal)
    ok, err = _close_err(got, fa.flash_attention_plain(q, k, v, causal),
                         FLASH_TOL[str(q.dtype)])
    if not ok:
        raise AssertionError(f"full-size flash_attention != plain ({err})")
    exact = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal)
    rel_l2 = float((got.float() - exact).norm() / exact.norm())
    del got, exact
    b, s, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    esz = q.element_size()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=h != hkv)

    lib_err = float((sdpa().transpose(1, 2).float()
                     - fa.flash_attention_plain(q, k, v, causal).float()
                     ).abs().max())
    # a causal mask aligns the first query with the first key: query i
    # keeps min(i + 1, Sk) keys
    pairs = (sum(min(i + 1, sk) for i in range(s)) if causal else s * sk)
    shape = [b, s, h, hkv, dh] if s == sk else [b, s, sk, h, hkv, dh]
    return {
        "shape": shape + ([dv] if dv != dh else []),
        "causal": causal, "dtype": str(q.dtype),
        "instance": fa.instance(q, k, v),
        "bytes_min": (b * s * h * (dh + dv) + b * sk * hkv * (dh + dv)) * esz,
        "operations": 2 * b * h * pairs * (dh + dv),
        "design_operations": 2 * b * h * pairs * (dh + 2 * dv),
        "max_abs_err": err, "library_max_abs_err": lib_err,
        "rel_l2_vs_float32": rel_l2,
        "ms": cuda_ms(torch, lambda: fa._launch(q, k, v, causal), 5),
        # the same launches queued behind a spin: the kernel's own time,
        # where the host's launch path is longer than a short kernel
        "queued_ms": queued_ms(torch, lambda: fa._launch(q, k, v, causal),
                               20),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal), 2),
        "library_ms": cuda_ms(torch, sdpa, 10),
        "library_queued_ms": queued_ms(torch, sdpa, 20)}


def bound_and_print(torch, name: str, o: dict) -> None:
    """Adds the bound max(bytes / 3.35 TB/s, operations / the peak of
    their type), what binds it, the achieved rate and the design floor to
    a timing ``o``, and prints it."""
    o["bytes_ms"] = 1e3 * o["bytes_min"] / HBM_BYTES_PER_S
    rate = BF16_OPS_PER_S if o["dtype"] == str(torch.bfloat16) \
        else FP32_OPS_PER_S
    o["ops_ms"] = 1e3 * o["operations"] / rate
    o["bound_ms"] = max(o["bytes_ms"], o["ops_ms"])
    o["bound_by"] = "bytes" if o["bytes_ms"] >= o["ops_ms"] else \
        "operations"
    o["achieved_tflops"] = o["operations"] / o["ms"] / 1e9
    if "design_bytes" in o:
        o["design_floor_ms"] = 1e3 * o["design_bytes"] / HBM_BYTES_PER_S
    if "design_operations" in o:
        o["design_floor_ms"] = 1e3 * o["design_operations"] / rate
    lib = ("none: no single call" if o["library_ms"] is None else
           f"scaled_dot_product_attention {o['library_ms']:.4f} ms")
    if "queued_ms" in o:
        lib += (f" (queued behind a spin: kernel {o['queued_ms']:.4f} ms, "
                f"SDPA {o['library_queued_ms']:.4f} ms)")
    print(f"{name} {o['shape']} {o['dtype']} ({o['bytes_min'] / 1e6:.1f} "
          f"MB, {o['operations'] / 1e9:.2f} GFLOP): kernel "
          f"{o['ms']:.4f} ms ({o['achieved_tflops']:.1f} TFLOP/s), plain "
          f"{o['plain_ms']:.3f} ms, {lib}, bound {o['bound_ms']:.4f} ms "
          f"({o['bound_by']}); max abs err vs plain {o['max_abs_err']:.3e}"
          + (f", rel L2 vs float32 {o['rel_l2_vs_float32']:.3e}"
             if "rel_l2_vs_float32" in o else "")
          + (f"; instance {o['instance']}" if "instance" in o else "")
          + (f"; design floor {o['design_floor_ms']:.4f} ms"
             if "design_floor_ms" in o else ""))


def phase_model_timing(torch, captured: dict, report: dict) -> dict:
    """Both model kernels at the long prefill's shapes (the first shared
    attention's and the first SSD layer's inputs): kernel against plain
    version on the full inputs, then the kernel's, the plain version's and
    (flash only) ``scaled_dot_product_attention``'s times, beside the
    bound max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s bf16): bytes each
    input read once and each output written once (the scan's final state
    included), FLOPs the function's need — the (query, key) pairs the
    causal mask keeps; C Bᵀ once per (batch, chunk) and the lower triangle
    of each chunk for the scan."""
    from repro_torch.kernels import ssd_scan as ss
    # the prefill's launch: q, k, v, causal and its lse (None, no grad)
    out = {"flash_attention": flash_timing(
        torch, *captured["flash_attention"][:4])}
    xs, bm, cm, dt, a, chunk = captured["ssd_scan"]
    y, st = ss._launch(xs, bm, cm, dt, a, chunk)
    y_want, st_want = ss.ssd_scan_plain(xs, bm, cm, dt, a, chunk)
    tol = SSD_TOL[str(xs.dtype)]
    (ok_y, err), (ok_s, err_s) = (_close_err(y, y_want, tol),
                                  _close_err(st, st_want, tol))
    if not (ok_y and ok_s):
        raise AssertionError(f"full-size ssd_scan != plain (y {err}, state "
                             f"{err_s})")
    del y, st, y_want, st_want
    b, l, h, p = xs.shape
    n = bm.shape[2]
    esz = xs.element_size()
    chunk_states = b * (l // chunk) * h * p * n * 4
    out["ssd_scan"] = {
        "shape": [b, l, h, p, n, chunk], "dtype": str(xs.dtype),
        "bytes_min": (2 * b * l * h * p + 2 * b * l * n) * esz
        + b * l * h * dt.element_size() + h * a.element_size()
        + b * h * p * n * 4,
        # the bf16 design's own traffic: x, B and dt read again by the
        # output pass, the float32 chunk states written, read and written,
        # and read again
        "design_bytes": (3 * b * l * h * p + 3 * b * l * n) * esz
        + 2 * b * l * h * dt.element_size() + 4 * chunk_states
        + b * h * p * n * 4,
        "operations": b * (l // chunk) * chunk * (chunk + 1) * (n + h * p)
        + b * h * 2 * p * n * (2 * l - chunk),
        "max_abs_err": err, "state_max_abs_err": err_s,
        "ms": cuda_ms(torch, lambda: ss._launch(xs, bm, cm, dt, a, chunk), 3),
        "plain_ms": cuda_ms(torch, lambda: ss.ssd_scan_plain(
            xs, bm, cm, dt, a, chunk), 2),
        "library_ms": None}
    for name, o in out.items():
        bound_and_print(torch, name, o)
    captured.clear()
    torch.cuda.synchronize()
    report["model_timing"] = out
    return out


def phase_model_profile(torch, model, seed: int, report: dict) -> None:
    """Where the serve path's device time goes: torch.profiler over 8
    decode steps of B = 4 at the serve phase's cache length (after 2
    unprofiled ones) and over one long prefill (B = 4, S = 4096): wall ms,
    device busy ms and share, the device ms by kernel (each trace is
    read and deleted: together they pass the 64 MiB a chip call brings
    back), and by name the rows of the port's own model kernels
    (``MODEL_KERNEL_NAMES``), which the prefill must show."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models import init_cache
    from repro_torch.serve.serve_step import (make_prefill_step,
                                              make_serve_step)
    cfg = configs.get(MODEL_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    tok = torch.randint(0, cfg.vocab, (SERVE_REQUESTS, 1), generator=gen,
                        device=DEVICE)
    tokens = torch.randint(0, cfg.vocab, (LONG_BATCH, LONG_SEQ), generator=gen,
                           device=DEVICE)
    step = make_serve_step(cfg, device=DEVICE)
    prefill = make_prefill_step(cfg, device=DEVICE)
    # the serve phase's decode shape: the last 10 of its cache's slots
    slots = SERVE_PROMPT + SERVE_DECODE
    state = {"cache": init_cache(cfg, SERVE_REQUESTS, slots,
                                 fill_len=slots - 10, device=DEVICE)}

    def decode():
        _, state["cache"] = step(model, {"tokens": tok,
                                         "cache": state["cache"]})

    def long_prefill():
        prefill(model, {"tokens": tokens})

    for _ in range(2):
        decode()
    out = {}
    for label, n, fn in (("decode", 8, decode), ("prefill", 1, long_prefill)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_ms, rows = trace_device_time(prof, label)
        (ROOT / "chiprun_out" / f"chip_smoke_trace_{label}.json").unlink()
        own = {key: [(ms, k) for name, ms, k in rows if key in name]
               for key in MODEL_KERNEL_NAMES}
        own = {key: (sum(ms for ms, _ in hits), sum(k for _, k in hits))
               for key, hits in own.items() if hits}
        out[label] = {"calls": n, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / wall_ms,
                      "device_ms_by_op": rows[:12],
                      "model_kernels": own}
        print(f"profile ({label}, {n} call{'s' * (n > 1)}): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%)")
        for name, ms, _ in rows[:12]:
            print(f"  {ms:9.3f} ms  {name[:90]}")
        for key, (ms, k) in own.items():
            print(f"  model kernel {key}: {ms:.3f} ms in {k} launches")
        lacking = sorted(set(MODEL_KERNEL_NAMES) - set(own))
        if label == "prefill" and lacking:
            raise AssertionError(f"the long prefill's trace lacks {lacking}")
    report["model_profile"] = out


def fill_cross_cache(model, cfg, cache: dict, enc_embeds) -> None:
    """An encoder-decoder's decode cache filled for the token path from the
    prefill's own encoder code: ``transformer._encode`` over the frames,
    then each decoder block's ``cross_kv_init`` of its output written into
    ``enc_k``/``enc_v`` (the first S_enc slots)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    enc, _ = T._encode(model, enc_embeds, cfg)
    n = enc.shape[1]
    for i, p in enumerate(model.layers):
        k, v = L.cross_kv_init(p.xattn, enc, cfg.attn_cfg(causal=False))
        cache["enc_k"][i, :, :n] = k
        cache["enc_v"][i, :, :n] = v


def recording_route(real_route, log: list):
    """A stand-in for the port's ``moe._route`` that routes as it does and
    appends (its experts (T, k), its float32 router logits (T, E)) to
    ``log``, one entry a call."""
    def route(x, router_w, mcfg):
        top_w, top_e = real_route(x, router_w, mcfg)
        log.append((top_e, x.float() @ router_w.float()))
        return top_w, top_e
    return route


def imposing_route(real_route, queue: list, seen: list):
    """A stand-in for the port's ``moe._route`` that takes, at each call,
    the next entry of ``queue`` (experts (T, k) another path chose, and
    that path's router logits (T, E)) in place of its own choice, weighted
    by its own probabilities at those experts, renormalised; it appends
    (its logits, its own experts, the experts taken, the other path's
    logits) to ``seen`` for ``routing_flips``."""
    def route(x, router_w, mcfg):
        _, own = real_route(x, router_w, mcfg)
        taken, z_other = queue.pop(0)
        z = x.float() @ router_w.float()
        seen.append((z, own, taken, z_other))
        w = z.softmax(-1).gather(1, taken)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), taken
    return route


def routing_flips(seen: list, bound: float) -> dict:
    """Where two paths' MoE routings part, over ``imposing_route``'s
    ``seen`` entries.  A flip is a token whose two expert sets differ.  The
    two paths' router logits of a token must agree within ``bound`` (a
    relative L2 distance, the rounding bound of the logits they feed):
    "drifted" counts the tokens that do not.  Where they agree, a flip can
    only be a reordering within their difference: every expert in one set
    but not the other must lie within 2 max|z - z_other| of the token's
    k-th router logit (two experts swap only if their gap is within both
    logits' moves); "untied" counts the flipped tokens with one that does
    not.  Returns {"flips", "untied", "drifted", "tokens",
    "rel_max"} summed over the entries."""
    out = {"flips": 0, "untied": 0, "drifted": 0, "tokens": 0,
           "rel_max": 0.0}
    for z, own, taken, z_other in seen:
        k = own.shape[1]
        dz = z - z_other
        rel = dz.norm(dim=-1) / z_other.norm(dim=-1).clamp_min(1e-30)
        in_own = own.new_zeros(z.shape, dtype=bool).scatter_(1, own, True)
        in_taken = own.new_zeros(z.shape, dtype=bool).scatter_(1, taken,
                                                                True)
        one_side = in_own ^ in_taken
        kth = z.sort(-1, descending=True).values[:, k - 1:k]
        far = ((z - kth).abs() > 2 * dz.abs().amax(-1, keepdim=True))
        out["flips"] += int(one_side.any(-1).sum())
        out["untied"] += int((far & one_side).any(-1).sum())
        out["drifted"] += int((rel > bound).sum())
        out["tokens"] += own.shape[0]
        out["rel_max"] = max(out["rel_max"], float(rel.max()))
    return out


def capacity_oracle_ffn(p, x, cfg):
    """``moe_ffn``'s function written out plainly, for the checks: every
    expert on every token (the dense oracle ``moe_ffn_local``), and a
    routed slot kept only while its expert has taken fewer than C slots
    before it, counted in the reference's slot order t·k + j by a running
    sum, not by the dispatch's sort.  Returns (y (B, S, d), dropped)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_w, top_e = MOE._route(xt, p.router.w, cfg)
    t, k = top_e.shape
    hot = F.one_hot(top_e.reshape(-1), cfg.n_experts)      # (t·k, E)
    rank = (hot.cumsum(0) * hot).sum(-1) - 1
    keep = (rank < MOE._capacity(t, cfg)).reshape(t, k)
    h = F.silu(torch.einsum("td,edf->tef", xt, p.wg.to(x.dtype)))
    h = h * torch.einsum("td,edf->tef", xt, p.wi.to(x.dtype))
    out = torch.einsum("tef,efd->ted", h, p.wo.to(x.dtype))
    sel = torch.take_along_dim(out, top_e[..., None], dim=1)  # (t, k, d)
    w = (top_w * keep).to(x.dtype)
    y = (sel * w[..., None]).sum(1).reshape(b, s, d)
    if p.shared is not None:
        y = y + L.swiglu(p.shared, x)
    return y, int((~keep).sum())


def phase_family_serve(torch, cfg, *, prompt_len: int, decode: int,
                       seed: int, instance: str, report: dict, key: str,
                       captured: dict, profile: bool = False,
                       extra=None) -> None:
    """One config through ``repro_torch.launch.serve`` on the card, as
    phase 11 drives Zamba2: seeded weights from ``init_params``, 4 prompts
    of ``prompt_len`` tokens from the CUR prompt store (``checkout_wave``),
    the cache filled token by token, ``decode`` greedy tokens, then
    ``make_prefill_step`` on the same prompts.  Checks: one
    ``flash_attention`` launch a layer (the ``instance`` named), all in the
    prefill, and no other model kernel; ``checkout_wave`` launched; the
    cache ``prompt_len + decode - 1`` long in ``prompt_len + decode``
    slots; finite logits and tokens in range; the prefill's next-token
    logits within serve's bf16 bound of the token path's.  With MoE
    layers, the served prefill is also held against ``capacity_oracle_ffn``
    (``served_capacity_check``), and where its drops break serve's check,
    ``full_capacity_check`` must pass.  Prints the routed slots the MoE
    dispatch dropped, per prefill layer.  The first prefill attention's
    inputs go to ``captured[key]``; with ``profile``, ``phase_moe_profile``
    runs on the model before it is freed, and so does ``extra(model, cfg,
    run)`` where one is given."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as driver
    from repro_torch.models import init_params
    from repro_torch.models import moe as MOE
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    kinds: dict = {}
    real = capture_flash_kinds(torch, kinds)
    real_route, routes = MOE._route, []
    MOE._route = recording_route(real_route, routes)   # every path's choices
    try:
        zero_launch_counts()                  # the serve path's window
        t0 = time.perf_counter()
        run = driver.serve(cfg, requests=SERVE_REQUESTS,
                           prompt_len=prompt_len, decode_steps=decode,
                           seed=seed, device=DEVICE, params=model,
                           log=lambda *_: None)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()            # the window closes
    finally:
        fa._launch, MOE._route = real, real_route
    captured[key] = next(iter(kinds.values()))      # the first call's
    del kinds
    res, check, cache = run["result"], run["check"], run["cache"]
    want = {"flash_attention": cfg.n_layers, "ssd_scan": 0}
    if (run["launches"]["prefill"] != want
            or any(run["launches"]["fill_decode"].values())
            or launches["flash_attention"] != cfg.n_layers
            or launches["checkout_wave"] <= 0
            or any(n for k, n in launches.items()
                   if k not in ("flash_attention", "checkout_wave"))):
        raise AssertionError(f"{cfg.name}: launches {run['launches']} "
                             f"(window {launches}), expected {want} in the "
                             f"prefill alone and checkout_wave")
    which = fa.instance(*captured[key][:3])
    if which != instance:
        raise AssertionError(f"{cfg.name}: the prefill's flash ran the "
                             f"{which} instance, not {instance}")
    max_len = prompt_len + decode
    leaf = cache["ckv" if cfg.attn_type == "mla" else "k"]
    if cache["len"] != max_len - 1 or leaf.shape[2] != max_len:
        raise AssertionError(f"{cfg.name}: cache {cache['len']} of "
                             f"{leaf.shape[2]} slots")
    tokens = run["tokens"]
    if not (torch.isfinite(run["fill_logits"]).all()
            and torch.isfinite(run["prefill_logits"]).all()
            and tokens.shape == (SERVE_REQUESTS, decode)
            and 0 <= tokens.min() and tokens.max() < cfg.vocab):
        raise AssertionError(f"{cfg.name}: non-finite logits or tokens out "
                             f"of range")
    dropped = run["dropped"]
    served = full = None
    if cfg.moe is not None:
        n_moe = cfg.n_layers - cfg.first_dense
        served = served_capacity_check(torch, model, cfg, run,
                                       routes[-n_moe:])
        if not check["ok"] and any(dropped["prefill"]):
            full = full_capacity_check(torch, model, cfg, run,
                                       routes[:prompt_len * n_moe])
    del routes
    report[key] = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
        "init_s": init_s, "wall_s": wall_s, "launches": run["launches"],
        "flash_instance": which, "cache_len": cache["len"],
        "cache_slots": max_len, "dropped": dropped, "check": check,
        "served_capacity_check": served, "full_capacity_check": full,
        "result": res}
    print(f"{key}: {cfg.name} ({n_params:,} params, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}) made in {init_s:.1f} s; "
          f"{SERVE_REQUESTS} x {prompt_len} prompt tokens filled token by "
          f"token in {res['prefill_s']} s, {decode} greedy tokens in "
          f"{res['decode_s']} s ({res['ms_per_decode_step']:.2f} ms a "
          f"step); make_prefill_step {res['prefill_step_s']:.3f} s; "
          f"launches {run['launches']} (flash {which}); cache "
          f"{cache['len']} of {max_len}")
    print(f"{key} prefill vs token-by-token at position {prompt_len - 1}: "
          f"rel L2 {[round(r, 5) for r in check['rel_l2']]} (bound "
          f"{check['bound']:.4f}), argmax agree {check['argmax_agree']}, gap "
          f"clear of the bound {check['gap_clear']}; routed slots dropped: "
          f"prefill {dropped['prefill']} by layer, fill and decode "
          f"{dropped['fill_decode']}")
    for name, c in (("served prefill", served), ("full capacity", full)):
        if c is None:
            continue
        for run_name in ("own", "imposed", "oracle"):
            if run_name in c:
                r = c[run_name]
                print(f"{key} {name}, {run_name}: rel L2 "
                      f"{[round(v, 5) for v in r['rel_l2']]} (bound "
                      f"{r['bound']:.4f}), argmax agree {r['argmax_agree']}, "
                      f"gap clear {r['gap_clear']}")
        f = c["routing"]
        print(f"{key} {name} routing: {f['flips']} of {f['tokens']} "
              f"token-layer choices differ, {f['untied']} outside their "
              f"logits' moves, {f['drifted']} with logits apart by more "
              f"than the bound (max rel {f['rel_max']:.5f})"
              + (f"; oracle drops {c['oracle_drops']}"
                 if "oracle_drops" in c else ""))
    if profile:
        phase_moe_profile(torch, model, cfg, prompt_len, seed, report)
    if extra is not None:
        extra(model, cfg, run)
    del model, run, cache
    gc.collect()
    torch.cuda.empty_cache()
    if served is not None and not served["ok"]:
        raise AssertionError(f"{cfg.name}: the served prefill vs the "
                             f"capacity oracle: {served}; dropped {dropped}")
    if not (check["ok"] or (full is not None and full["ok"])):
        raise AssertionError(f"{cfg.name}: prefill vs token-by-token: "
                             f"{check}; dropped {dropped}; at full capacity "
                             f"{full}")


def served_capacity_check(torch, model, cfg, run: dict, routes: list) -> dict:
    """The served prefill, drops and all, against its function written out
    plainly: the same prefill on the same prompts with every MoE block's
    ``moe_ffn`` replaced by ``capacity_oracle_ffn`` and the served
    prefill's own experts imposed (``routes``: its choices, layer by
    layer), held to serve's prefill check and bound; each layer must drop
    exactly the served prefill's slots, and the routing must part only as
    ``routing_flips`` allows."""
    from repro_torch.launch import serve as driver
    from repro_torch.models import moe as MOE
    from repro_torch.serve.serve_step import make_prefill_step
    tokens = torch.from_numpy(run["prompts"]).to(DEVICE)
    bound = run["check"]["bound"]
    queue, seen, drops = list(routes), [], []
    real_route, real_ffn = MOE._route, MOE.moe_ffn

    def oracle(p, x, mcfg):
        y, n = capacity_oracle_ffn(p, x, mcfg)
        drops.append(n)
        return y
    MOE._route = imposing_route(real_route, queue, seen)
    MOE.moe_ffn = oracle
    try:
        logits = make_prefill_step(cfg, device=DEVICE)(model,
                                                       {"tokens": tokens})
    finally:
        MOE._route, MOE.moe_ffn = real_route, real_ffn
    served = driver.prefill_check(logits[:, -1, :cfg.vocab].float(),
                                  run["prefill_logits"], bound)
    routing = routing_flips(seen, bound)
    ok = (served["ok"] and drops == run["dropped"]["prefill"] and not queue
          and routing["untied"] == 0 and routing["drifted"] == 0)
    return {"oracle": served, "oracle_drops": drops, "routing": routing,
            "ok": ok}


def full_capacity_check(torch, model, cfg, run: dict, routes: list) -> dict:
    """The served prefill dropped routed slots past its capacity, which
    the token path (B tokens a step) never does, so the two compute
    different functions.  This runs the same prefill on the same prompts
    with the capacity factor at E / k (a capacity of every token: no slot
    can drop) and holds it against the token path's logits with
    serve's prefill check and bound, unchanged: once with its own routing
    ("own"), and once taking the experts the token path chose at each
    (position, layer) (``routes``: the fill's choices and router logits,
    step by step and layer by layer) ("imposed").  A choice that differs
    from the prefill's own is a routing discontinuity, not a rounding
    error, and must part only as ``routing_flips`` allows; "ok" asks
    that of the imposed run with its check."""
    from repro_torch.launch import serve as driver
    from repro_torch.models import moe as MOE
    from repro_torch.serve.serve_step import make_prefill_step
    factor = cfg.moe.n_experts / cfg.moe.top_k
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    tokens = torch.from_numpy(run["prompts"]).to(DEVICE)
    bound = run["check"]["bound"]
    b, s = tokens.shape
    n_moe = cfg.n_layers - cfg.first_dense
    queue = [tuple(torch.stack([r[i] for r in routes[l::n_moe]], dim=1)
                   .reshape(b * s, -1) for i in range(2))
             for l in range(n_moe)]
    real_route, seen = MOE._route, []
    prefill = make_prefill_step(wide, device=DEVICE)
    out = {"capacity_factor": factor}
    for name in ("own", "imposed"):
        if name == "imposed":
            MOE._route = imposing_route(real_route, queue, seen)
        try:
            with MOE.counting_drops() as drops:
                logits = prefill(model, {"tokens": tokens})
        finally:
            MOE._route = real_route
        if any(MOE.drop_counts(drops)):
            raise AssertionError(f"{cfg.name}: {MOE.drop_counts(drops)} "
                                 f"slots dropped at capacity factor "
                                 f"{factor}")
        out[name] = driver.prefill_check(logits[:, -1, :cfg.vocab].float(),
                                         run["fill_logits"], bound)
    out["routing"] = routing_flips(seen, bound)
    out["ok"] = (out["imposed"]["ok"] and not queue
                 and out["routing"]["untied"] == 0
                 and out["routing"]["drifted"] == 0)
    return out


MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def trace_ranges(label: str, names) -> dict:
    """Device time of the kernels launched inside each ``record_function``
    range named in ``names``, from the exported trace
    chiprun_out/chip_smoke_trace_<label>.json: each kernel, copy or memset
    is matched through its correlation id to the runtime call that
    launched it, and that call to the innermost such range around it.
    {range: {"ms", "launches", "by_kernel": [(name, ms, n)]}}."""
    events = json.loads((ROOT / "chiprun_out" /
                         f"chip_smoke_trace_{label}.json").read_text()
                        )["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {n: {"ms": 0.0, "launches": 0, "by_kernel": {}} for n in names}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        inside = [sp for sp in spans if sp[0] <= ts <= sp[1]]
        if not inside:
            continue
        row = out[max(inside)[2]]             # the innermost: latest start
        row["ms"] += e["dur"] / 1e3
        row["launches"] += 1
        ms, n = row["by_kernel"].get(e["name"], (0.0, 0))
        row["by_kernel"][e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    for row in out.values():
        row["by_kernel"] = sorted(((k, ms, n) for k, (ms, n)
                                   in row["by_kernel"].items()),
                                  key=lambda r: -r[1])[:6]
    return out


def phase_moe_profile(torch, model, cfg, prompt_len: int, seed: int,
                      report: dict) -> None:
    """Where an MoE model's serving time goes: torch.profiler over 8 decode
    steps at B = 4 (after 2 unprofiled ones, at the serve phase's cache
    length) and over one serving prefill (4 x ``prompt_len``): wall ms,
    device busy ms and share, device ms by kernel, and the MoE block's
    parts apart: each of routing, dispatch (the sort and the scatter into
    the expert buffer), the expert products (the weights' casts and the
    batched products) and the combine wrapped in a ``record_function``
    range for the pass, and the kernels launched in each range summed
    (``trace_ranges``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import init_cache
    from repro_torch.models import moe as MOE
    from repro_torch.serve.serve_step import (make_prefill_step,
                                              make_serve_step)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    tok = torch.randint(0, cfg.vocab, (SERVE_REQUESTS, 1), generator=gen,
                        device=DEVICE)
    tokens = torch.randint(0, cfg.vocab, (SERVE_REQUESTS, prompt_len),
                           generator=gen, device=DEVICE)
    step = make_serve_step(cfg, device=DEVICE)
    prefill = make_prefill_step(cfg, device=DEVICE)
    slots = prompt_len + SERVE_DECODE
    state = {"cache": init_cache(cfg, SERVE_REQUESTS, slots,
                                 fill_len=slots - 10, device=DEVICE)}

    def decode():
        _, state["cache"] = step(model, {"tokens": tok,
                                         "cache": state["cache"]})

    def serving_prefill():
        prefill(model, {"tokens": tokens})

    parts = {name: getattr(MOE, "_" + name.split(".")[1])
             for name in MOE_RANGES}

    def ranged(name, fn):
        def wrapped(*args):
            with record_function(name):
                return fn(*args)
        return wrapped

    for _ in range(2):
        decode()
    out = {}
    try:
        for name, fn in parts.items():
            setattr(MOE, "_" + name.split(".")[1], ranged(name, fn))
        for label, n, fn in (("moe_decode", 8, decode),
                             ("moe_prefill", 1, serving_prefill)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            busy_ms, rows = trace_device_time(prof, label)
            ranges = trace_ranges(label, MOE_RANGES)
            (ROOT / "chiprun_out" / f"chip_smoke_trace_{label}.json").unlink()
            out[label] = {"calls": n, "wall_ms": wall_ms,
                          "device_busy_ms": busy_ms,
                          "device_busy_share": busy_ms / wall_ms,
                          "device_ms_by_op": rows[:12], "moe_parts": ranges}
            print(f"profile ({cfg.name} {label}, {n} call{'s' * (n > 1)}): "
                  f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
                  f"({100 * busy_ms / wall_ms:.1f}%)")
            for name, ms, k in rows[:12]:
                print(f"  {ms:9.3f} ms  {k:5d}x  {name[:90]}")
            for name, row in ranges.items():
                print(f"  {name}: {row['ms']:.3f} ms in {row['launches']} "
                      f"launches: " + "; ".join(
                          f"{k[:48]} {ms:.3f} ms/{n}"
                          for k, ms, n in row["by_kernel"]))
    finally:
        for name, fn in parts.items():
            setattr(MOE, "_" + name.split(".")[1], fn)
    report["moe_profile"] = out


def phase_families(torch, seed: int, report: dict) -> dict:
    """Phases 15-17: OLMoE-1B-7B at full size, DeepSeek-V2-Lite at full
    width and ``MLA_DEPTH`` layers, and the three dense configs at full
    width and ``DENSE_DEPTH`` layers, each through ``phase_family_serve``.
    Returns the first prefill attention's inputs of the first two (for
    ``phase_family_flash_timing``)."""
    from repro_torch import configs
    captured: dict = {}
    phase_family_serve(torch, configs.get(MOE_ARCH), prompt_len=SERVE_PROMPT,
                       decode=SERVE_DECODE, seed=seed, instance="wgmma",
                       report=report, key="moe_serve", captured=captured,
                       profile=True)
    phase_family_serve(torch, dataclasses.replace(configs.get(MLA_ARCH),
                                                  n_layers=MLA_DEPTH),
                       prompt_len=SERVE_PROMPT, decode=SERVE_DECODE,
                       seed=seed, instance="wgmma", report=report,
                       key="mla_serve", captured=captured)
    dense = {}
    for arch in DENSE_ARCHS:
        phase_family_serve(torch, dataclasses.replace(configs.get(arch),
                                                      n_layers=DENSE_DEPTH),
                           prompt_len=DENSE_PROMPT, decode=DENSE_DECODE,
                           seed=seed, instance="wgmma", report=dense,
                           key=arch, captured={})
    report["dense_serve"] = dense
    return captured


def phase_family_flash_timing(torch, captured: dict, report: dict) -> None:
    """Phase 13's flash timing (``flash_timing``) again at OLMoE's first
    layer's prefill inputs (Dh 128, the wgmma instance) and at
    DeepSeek-V2-Lite's latent-attention inputs (q·k 192, v 128: the
    (192, 128) wgmma instance), v as the model passes it: the view
    ``kv[..., qk_nope:]`` of rows qk_nope + v_head wide, read in place.
    Beside the latter: the kernel on a contiguous copy of v (what reading
    v in place saves), and the old path on v zero-padded to 192 (the
    mma.sync instance, sliced back) with SDPA on the same padded inputs,
    so the row's earlier yardstick stays comparable."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for key in ("moe_serve", "mla_serve"):
        q, k, v, causal = captured.pop(key)
        if v.shape[3] != q.shape[3] and fa.v_pitch(v) == v.shape[3]:
            raise AssertionError(f"{report[key]['arch']}'s prefill passed v "
                                 f"contiguous, not the view of kv's rows")
        out[key] = flash_timing(torch, q, k, v, causal)
        bound_and_print(torch, f"flash_attention at {report[key]['arch']}'s "
                        f"prefill", out[key])
        if v.shape[3] != q.shape[3]:
            dqk, dv = q.shape[3], v.shape[3]
            pitch = fa.v_pitch(v) * v.element_size()
            vc = v.contiguous()
            got = fa._launch(q, k, vc, causal)
            want = fa.flash_attention_plain(q, k, v, causal)
            cont_ok, cont_err = _close_err(got, want, FLASH_TOL[str(q.dtype)])
            vp = F.pad(v, (0, dqk - dv))
            old = fa._launch(q, k, vp, causal)[..., :dv]
            pad_ok, pad_err = _close_err(old, want, FLASH_TOL[str(q.dtype)])
            if not (cont_ok and pad_ok):
                raise AssertionError(f"latent flash on a contiguous v "
                                     f"({cont_err}) or padded ({pad_err}) "
                                     f"!= plain")
            qt, kt, vpt = (x.transpose(1, 2) for x in (q, k, vp))
            def padded_sdpa():
                return F.scaled_dot_product_attention(qt, kt, vpt,
                                                      is_causal=causal)

            out[key].update({
                "v_pitch_bytes": pitch,
                "contiguous_ms": cuda_ms(torch, lambda: fa._launch(
                    q, k, vc, causal), 5),
                "contiguous_queued_ms": queued_ms(torch, lambda: fa._launch(
                    q, k, vc, causal), 20),
                "contiguous_max_abs_err": cont_err,
                "padded_instance": fa.instance(q, k, vp),
                "padded_ms": cuda_ms(torch, lambda: fa._launch(
                    q, k, vp, causal), 5),
                "padded_queued_ms": queued_ms(torch, lambda: fa._launch(
                    q, k, vp, causal), 20),
                "padded_max_abs_err": pad_err,
                "padded_library_ms": cuda_ms(torch, padded_sdpa, 10),
                "padded_library_queued_ms": queued_ms(torch, padded_sdpa,
                                                      20)})
            o = out[key]
            print(f"  latent flash: v read in place at the model's "
                  f"{pitch}-byte row pitch (above); on a contiguous copy "
                  f"{o['contiguous_ms']:.4f} ms, queued "
                  f"{o['contiguous_queued_ms']:.4f} (max abs err "
                  f"{cont_err:.3e}); the old path on v padded to {dqk} "
                  f"({o['padded_instance']}) {o['padded_ms']:.4f} ms, queued "
                  f"{o['padded_queued_ms']:.4f}, SDPA on the padded inputs "
                  f"{o['padded_library_ms']:.4f} ms, queued "
                  f"{o['padded_library_queued_ms']:.4f}; the "
                  f"{o['instance']} instance "
                  f"{o['queued_ms'] / o['padded_queued_ms']:.3f}x the old "
                  f"path (queued)")
            del vc, got, want, vp, old, qt, kt, vpt
        del q, k, v
    torch.cuda.synchronize()
    report["family_flash_timing"] = out


def capture_flash_kinds(torch, captured: dict):
    """A stand-in for ``flash_attention``'s counted launch that keeps a copy
    of the first call's inputs of each kind, ``captured[(Sq, Sk,
    causal)]``, each with the strides it came with (a v read in place as a
    view keeps its row pitch), and launches (and counts) as the real one
    does; returns the real one, to put back."""
    from repro_torch.kernels import flash_attention as fa
    real = fa._launch

    def copy(x):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device).copy_(x)

    def launch(q, k, v, causal, lse=None):
        kind = (q.shape[1], k.shape[1], bool(causal))
        if kind not in captured:
            captured[kind] = [copy(q), copy(k), copy(v), causal]
        return real(q, k, v, causal, lse)
    fa._launch = launch
    return real


def plain_flash(torch):
    """A context in which ``ops.flash_attention`` runs flash's plain
    version on the card, forward and backward (the comparison's plain
    path): ``fa.flash_attention`` is the one name of every forward launch,
    with the lse or without, and with no lse from it the backward is the
    plain ``ops._flash_bwd``."""
    from repro_torch.kernels import flash_attention as fa

    def plain(q, k, v, causal=True, lse=False):
        out = fa.flash_attention_plain(q, k, v, causal)
        return (out, None) if lse else out
    return swap_plain(fa, "flash_attention", plain)


def phase_encdec_serve(torch, seed: int, report: dict) -> dict:
    """Phase 20: Seamless-M4T-medium as its config gives it (12 encoder and
    12 decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab
    256,206 tied; weights from a seeded generator).  The serve driver
    refuses an encoder-decoder (as the reference's does), so the phase
    drives the serving steps itself with the serve driver's traffic: 4
    prompts of 512 tokens from the CUR prompt store (``checkout_wave``),
    544 seeded bf16 frame embeddings a request as the encoder memory (the
    stub frontend), the decode cache's ``enc_k``/``enc_v`` filled from the
    prefill's own encoder code (``fill_cross_cache``), the prompts fed token
    by token through ``make_serve_step``, 32 greedy tokens, then one
    ``make_prefill_step`` on the prompts and frames.  Checks, in one launch
    window: 48 ``flash_attention`` launches (12 in the cache's encoder
    pass; 36 in the prefill: 12 non-causal encoder self-attentions, 12
    causal decoder self-attentions, 12 cross-attentions of 512 queries
    against 544 frames), ``checkout_wave`` and no other kernel; the
    prefill's next-token logits within ``prefill_bound`` of the token
    path's (serve's check), and within it of the same prefill through
    flash's plain version on the card; finite logits, tokens in range, the
    cache 543 of 544.  Returns the first inputs of each flash kind."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as driver
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.serve_step import (make_prefill_step,
                                              make_serve_step)
    cfg = configs.get(ENCDEC_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    frames = torch.randn((SERVE_REQUESTS, ENCDEC_FRAMES, cfg.d_model),
                         generator=torch.Generator(device=DEVICE).manual_seed(
                             seed + 5), device=DEVICE).to(torch.bfloat16)
    max_len = SERVE_PROMPT + SERVE_DECODE
    step = make_serve_step(cfg, device=DEVICE)
    prefill = make_prefill_step(cfg, device=DEVICE)
    captured: dict = {}
    real = capture_flash_kinds(torch, captured)
    try:
        zero_launch_counts()                  # the encoder-decoder's window
        rows = driver.prompt_store(cfg.vocab, requests=SERVE_REQUESTS,
                                   prompt_len=SERVE_PROMPT, seed=seed,
                                   device=DEVICE, log=lambda *_: None)
        prompts = torch.from_numpy(rows).to(DEVICE)
        t0 = time.perf_counter()
        with torch.inference_mode():
            cache = init_cache(cfg, SERVE_REQUESTS, max_len, device=DEVICE)
            fill_cross_cache(model, cfg, cache, frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(SERVE_PROMPT):
            logits, cache = step(model, {"tokens": prompts[:, i:i + 1],
                                         "cache": cache})
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        fill_logits = logits[:, -1].float()
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(SERVE_DECODE - 1):
            logits, cache = step(model, {"tokens": tok, "cache": cache})
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        after_fill = launch_counts()
        batch = {"tokens": prompts, "enc_embeds": frames}
        t0 = time.perf_counter()
        pre = prefill(model, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = launch_counts()            # the window closes
    finally:
        fa._launch = real
    pre = pre[:, -1, :cfg.vocab].float()
    bound = driver.prefill_bound(cfg)
    check = driver.prefill_check(pre, fill_logits, bound)
    with plain_flash(torch):
        plain = prefill(model, batch)[:, -1, :cfg.vocab].float()
    plain_check = driver.prefill_check(pre, plain, bound)
    want = cfg.n_enc_layers + (cfg.n_enc_layers + 2 * cfg.n_layers)
    if (launches["flash_attention"] != want
            or after_fill["flash_attention"] != cfg.n_enc_layers
            or launches["checkout_wave"] <= 0
            or any(n for k, n in launches.items()
                   if k not in ("flash_attention", "checkout_wave"))):
        raise AssertionError(f"{cfg.name}: launches {launches} (after the "
                             f"cache's encoder pass and the fill "
                             f"{after_fill}), expected {want} flash, "
                             f"{cfg.n_enc_layers} before the prefill")
    kinds = {(ENCDEC_FRAMES, ENCDEC_FRAMES, False),
             (SERVE_PROMPT, SERVE_PROMPT, True),
             (SERVE_PROMPT, ENCDEC_FRAMES, False)}
    if set(captured) != kinds:
        raise AssertionError(f"{cfg.name}: flash ran {sorted(captured)}, "
                             f"expected {sorted(kinds)}")
    tokens = torch.cat(out, dim=1).cpu().numpy()
    if not (torch.isfinite(fill_logits).all() and torch.isfinite(pre).all()
            and tokens.shape == (SERVE_REQUESTS, SERVE_DECODE)
            and 0 <= tokens.min() and tokens.max() < cfg.vocab
            and cache["len"] == max_len - 1
            and cache["enc_k"].shape[2] == max_len):
        raise AssertionError(f"{cfg.name}: non-finite logits, tokens out of "
                             f"range or cache {cache['len']} of "
                             f"{cache['enc_k'].shape[2]}")
    instances = {str(kind): fa.instance(*args[:3])
                 for kind, args in captured.items()}
    report["encdec_serve"] = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "frames": ENCDEC_FRAMES, "encoder_cache_s": enc_s, "fill_s": fill_s,
        "decode_s": decode_s,
        "ms_per_decode_step": 1e3 * decode_s / max(SERVE_DECODE - 1, 1),
        "prefill_s": prefill_s, "launches": {"window": launches,
                                             "encoder_and_fill": after_fill},
        "flash_instances": instances, "check": check,
        "plain_check": plain_check, "cache_len": cache["len"],
        "sample": tokens[0, :8].tolist()}
    print(f"encdec_serve: {cfg.name} ({n_params:,} params, "
          f"{cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) made in {init_s:.1f} s; {SERVE_REQUESTS} x "
          f"{ENCDEC_FRAMES} frames, the cache's encoder K/V in {enc_s:.3f} s; "
          f"{SERVE_REQUESTS} x {SERVE_PROMPT} prompt tokens filled token by "
          f"token in {fill_s:.2f} s, {SERVE_DECODE} greedy tokens in "
          f"{decode_s:.2f} s ({report['encdec_serve']['ms_per_decode_step']:.2f}"
          f" ms a step); make_prefill_step {prefill_s:.3f} s; launches "
          f"{launches} ({after_fill['flash_attention']} before the prefill);"
          f" flash instances {instances}; cache {cache['len']} of {max_len}")
    print(f"encdec_serve prefill vs token-by-token at position "
          f"{SERVE_PROMPT - 1}: rel L2 {[round(r, 5) for r in check['rel_l2']]}"
          f" (bound {bound:.4f}), argmax agree {check['argmax_agree']}; vs "
          f"the plain flash prefill: rel L2 "
          f"{[round(r, 5) for r in plain_check['rel_l2']]}")
    del model, cache, frames, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not check["ok"]:
        raise AssertionError(f"{cfg.name}: prefill vs token-by-token: {check}")
    if not plain_check["ok"]:
        raise AssertionError(f"{cfg.name}: prefill through the kernel vs "
                             f"plain: {plain_check}")
    return captured


def vlm_checks(torch, seed: int, report: dict, kept: dict):
    """Phase 21's checks beyond serve's, on the served model before it is
    freed (``phase_family_serve``'s ``extra``): a prefill of the served
    prompts with seeded random bf16 ``patch_embeds`` through the kernel
    against the same prefill through flash's plain version, and
    ``loss_fn`` (its patch mask) on that batch, kernel against plain, both
    within ``prefill_bound``; keeps the dense cache's K/V in ``kept`` for
    phase 22."""
    from repro_torch.launch import serve as driver
    from repro_torch.models import loss_fn
    from repro_torch.serve.serve_step import make_prefill_step

    def extra(model, cfg, run):
        prompts = torch.from_numpy(run["prompts"]).to(DEVICE)
        patches = torch.randn(
            (SERVE_REQUESTS, cfg.n_patches, cfg.d_model),
            generator=torch.Generator(device=DEVICE).manual_seed(seed + 6),
            device=DEVICE).to(torch.bfloat16)
        batch = {"tokens": prompts, "patch_embeds": patches,
                 "labels": torch.roll(prompts, -1, dims=1)}
        prefill = make_prefill_step(cfg, device=DEVICE)
        bound = driver.prefill_bound(cfg)
        got = prefill(model, batch)[:, -1, :cfg.vocab].float()
        with torch.inference_mode():
            loss = float(loss_fn(model, batch, cfg))
        with plain_flash(torch):
            want = prefill(model, batch)[:, -1, :cfg.vocab].float()
            with torch.inference_mode():
                loss_plain = float(loss_fn(model, batch, cfg))
        check = driver.prefill_check(got, want, bound)
        loss_rel = abs(loss - loss_plain) / abs(loss_plain)
        cache = run["cache"]
        kept.update(k=cache["k"], v=cache["v"], len=cache["len"])
        report["vlm_checks"] = {"patch_prefill": check, "loss": loss,
                                "loss_plain": loss_plain,
                                "loss_rel": loss_rel, "bound": bound}
        print(f"vlm_serve with random patch embeddings: prefill through the "
              f"kernel vs plain rel L2 {[round(r, 5) for r in check['rel_l2']]}"
              f" (bound {bound:.4f}); loss_fn (patch positions masked) "
              f"{loss:.6f} vs {loss_plain:.6f} plain (rel {loss_rel:.2e})")
        if not (check["ok"] and loss_rel <= bound
                and math.isfinite(loss)):
            raise AssertionError(f"{cfg.name}: random patches, kernel vs "
                                 f"plain: {report['vlm_checks']}")
    return extra


def phase_paged_cache(torch, kept: dict, report: dict) -> None:
    """Phase 22: the paged KV cache (``repro_torch.serve.kvcache``) at the
    reference's default ``PagedConfig`` (pages of 64 tokens, 256 pages,
    64 a request) and phase 21's geometry (4 layers, 8 kv heads of 128,
    bf16: a 268 MB pool), batch 8, on the card.  The 4 served requests'
    K/V are appended token by token from phase 21's dense cache; each
    request's gathered history at every layer must equal the dense rows
    bit for bit under its mask.  Request 0 is forked into slots 4-7, and
    8 seeded tokens appended to each: copy-on-write must copy exactly the
    shared tail page (one fresh page a fork, the rest of each table still
    request 0's), the forks' prefix must equal request 0's and their tails
    the appended tokens.  Requests 1-3 are released and request 1 takes
    new tokens: its pages must be freed ones, the watermark unchanged.
    Every state leaf and ``pool_stats`` must equal a CPU run of the same
    operations.  Appends and gathers are timed on the host clock."""
    from repro_torch.serve import kvcache as kv
    cfg = kv.PagedConfig(n_layers=LLAVA_DEPTH, n_kv=kept["k"].shape[3],
                         head_dim=kept["k"].shape[4])
    n_req, n_tok = kept["k"].shape[1], int(kept["len"])
    if n_tok % cfg.page == 0:
        raise AssertionError(f"paged cache: {n_tok} tokens fill their last "
                             f"page; the forks would share no tail page")
    ops: list = []                    # (name, args) for the CPU replay

    def run(state, name, *args):
        getattr(kv, name)(cfg, state, *args)
        ops.append((name, args))

    state = kv.init_pool(cfg, 2 * n_req, device=DEVICE)
    pool_bytes = 2 * state["k"].numel() * state["k"].element_size()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(n_req):
        for t in range(n_tok):
            run(state, "append", (kept["k"][:, r, t], kept["v"][:, r, t]), r)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in range(n_req):
        for layer in range(cfg.n_layers):
            k, v, mask = kv.gather_kv(cfg, state, r, layer)
            if not (int(mask.sum()) == n_tok
                    and torch.equal(k[:n_tok], kept["k"][layer, r, :n_tok])
                    and torch.equal(v[:n_tok], kept["v"][layer, r, :n_tok])):
                raise AssertionError(f"paged cache: request {r} layer "
                                     f"{layer} != the dense cache")
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    served = kv.pool_stats(state)
    for dst in range(n_req, 2 * n_req):
        run(state, "fork", 0, dst)
    forked = kv.pool_stats(state)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    tails = torch.randn((n_req, VLM_DECODE, 2, cfg.n_layers, cfg.n_kv,
                         cfg.head_dim), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
    for i, dst in enumerate(range(n_req, 2 * n_req)):
        for t in range(VLM_DECODE):
            run(state, "append", (tails[i, t, 0], tails[i, t, 1]), dst)
    diverged = kv.pool_stats(state)
    last = (n_tok - 1) // cfg.page
    table = state["table"].to("cpu", copy=True)
    for i, dst in enumerate(range(n_req, 2 * n_req)):
        same = torch.equal(table[dst, :last], table[0, :last])
        if not same or table[dst, last] == table[0, last]:
            raise AssertionError(f"paged cache: fork {dst}'s table "
                                 f"{table[dst, :last + 1].tolist()} vs "
                                 f"{table[0, :last + 1].tolist()}")
        for layer in range(cfg.n_layers):
            k0 = kv.gather_kv(cfg, state, 0, layer)[0]
            k, v, mask = kv.gather_kv(cfg, state, dst, layer)
            if not (int(mask.sum()) == n_tok + VLM_DECODE
                    and torch.equal(k[:n_tok], k0[:n_tok])
                    and torch.equal(k[n_tok:n_tok + VLM_DECODE],
                                    tails[i, :, 0, layer])
                    and torch.equal(v[n_tok:n_tok + VLM_DECODE],
                                    tails[i, :, 1, layer])):
                raise AssertionError(f"paged cache: fork {dst} layer {layer}")
    pages = last + 1
    grown = n_req * pages + n_req         # one copied tail page a fork
    if not (served == {"pages_in_use": n_req * pages,
                       "watermark": n_req * pages, "shared_pages": 0}
            and forked == dict(served, shared_pages=pages)
            and diverged == {"pages_in_use": grown, "watermark": grown,
                             "shared_pages": pages - 1}):
        raise AssertionError(f"paged cache: pool {served} -> fork {forked} "
                             f"-> copy-on-write {diverged}")
    for r in range(1, n_req):
        run(state, "release", r)
    freed = set(table[1:n_req, :pages].flatten().tolist())
    for t in range(2 * cfg.page + 5):
        run(state, "append", (kept["k"][:, 0, t], kept["v"][:, 0, t]), 1)
    reused = state["table"][1, :3].tolist()
    final = kv.pool_stats(state)
    if not (set(reused) <= freed
            and final["watermark"] == diverged["watermark"]):
        raise AssertionError(f"paged cache: after release, request 1 took "
                             f"pages {reused}, watermark "
                             f"{diverged['watermark']} -> "
                             f"{final['watermark']}")
    cpu = kv.init_pool(cfg, 2 * n_req, device="cpu")
    t0 = time.perf_counter()
    for name, args in ops:
        if name == "append":
            args = (tuple(x.cpu() for x in args[0]), args[1])
        getattr(kv, name)(cfg, cpu, *args)
    replay_s = time.perf_counter() - t0
    differ = [n for n in state if not torch.equal(state[n].cpu(), cpu[n])]
    if differ or kv.pool_stats(cpu) != final:
        raise AssertionError(f"paged cache: the card's state differs from "
                             f"the CPU run's in {differ}")
    n_appends = sum(name == "append" for name, _ in ops)
    report["paged_cache"] = {
        "config": dataclasses.asdict(cfg), "batch": 2 * n_req,
        "pool_bytes": pool_bytes, "tokens_per_request": n_tok,
        "appends": n_appends, "append_s": append_s,
        "append_ms_per_token": 1e3 * append_s / (n_req * n_tok),
        "gathers": n_req * cfg.n_layers, "gather_s": gather_s,
        "gather_ms": 1e3 * gather_s / (n_req * cfg.n_layers),
        "served": served, "forked": forked, "diverged": diverged,
        "final": final, "reused_pages": reused, "cpu_replay_s": replay_s}
    print(f"paged cache: {cfg.n_layers} layers x {cfg.n_pages} pages of "
          f"{cfg.page} tokens x {cfg.n_kv} x {cfg.head_dim} bf16 "
          f"({pool_bytes / 1e6:.1f} MB), batch {2 * n_req}; {n_req} x "
          f"{n_tok} tokens appended from the dense cache in {append_s:.3f} s "
          f"({report['paged_cache']['append_ms_per_token']:.4f} ms a token, "
          f"host clock), {n_req * cfg.n_layers} gathers bit-identical in "
          f"{gather_s:.4f} s ({report['paged_cache']['gather_ms']:.4f} ms "
          f"each); pool {served} -> forks {forked} -> {VLM_DECODE} tokens "
          f"a fork {diverged} (one copied tail page a fork); released 3, "
          f"request 1 reused pages {reused}, {final}; the CPU replay of "
          f"{len(ops)} operations equal leaf for leaf ({replay_s:.2f} s)")


def phase_vlm_serve(torch, seed: int, report: dict) -> dict:
    """Phases 21-22: LLaVA-NeXT-34B at full width and ``LLAVA_DEPTH``
    layers through ``phase_family_serve`` (4 prompts of 1,024 tokens, 8
    greedy tokens; serve's prefill passes the prompts' own first 576 token
    embeddings as the patch embeddings), ``vlm_checks`` on the model before
    it is freed, then the paged cache on its dense cache.  Returns the
    first prefill attention's inputs."""
    from repro_torch import configs
    captured: dict = {}
    kept: dict = {}
    cfg = dataclasses.replace(configs.get(VLM_ARCH), n_layers=LLAVA_DEPTH)
    phase_family_serve(torch, cfg, prompt_len=VLM_PROMPT, decode=VLM_DECODE,
                       seed=seed, instance="wgmma", report=report,
                       key="vlm_serve", captured=captured,
                       extra=vlm_checks(torch, seed, report, kept))
    phase_paged_cache(torch, kept, report)
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return captured["vlm_serve"]


def phase_new_family_flash_timing(torch, encdec: dict, vlm: list,
                                  report: dict) -> None:
    """``flash_timing`` at the first inputs of each flash kind of phases
    20-21: Seamless's non-causal encoder self-attention (4, 544, 16, 16,
    64), causal decoder self-attention (4, 512, 16, 16, 64) and
    cross-attention (Sq 512 against Sk 544, non-causal), and LLaVA's
    causal GQA with 7 query heads a kv head (4, 1024, 56, 8, 128)."""
    out = {}
    names = {(ENCDEC_FRAMES, ENCDEC_FRAMES, False): "seamless encoder",
             (SERVE_PROMPT, SERVE_PROMPT, True): "seamless decoder",
             (SERVE_PROMPT, ENCDEC_FRAMES, False): "seamless cross"}
    for kind, name in names.items():
        out[name] = flash_timing(torch, *encdec.pop(kind))
    out["llava"] = flash_timing(torch, *vlm)
    vlm.clear()
    for name, o in out.items():
        bound_and_print(torch, f"flash_attention at {name}", o)
    torch.cuda.synchronize()
    report["new_family_flash_timing"] = out


TRAIN_RANGES = ("train.forward", "train.backward", "train.optimizer")


def swap_plain(module, name: str, plain):
    """A context in which ``module.<name>`` (a kernel wrapper) is ``plain``:
    the step-0 comparison's plain path through the same entry points."""
    @contextlib.contextmanager
    def swapped():
        kept = getattr(module, name)
        setattr(module, name, plain)
        try:
            yield
        finally:
            setattr(module, name, kept)
    return swapped()


def step0_check(torch, cfg, model, batch, plain_ctx) -> dict:
    """One step's loss and gradients (``accumulate_grads``) through the
    kernels, against the same step with a kernel's plain version on the
    card (``plain_ctx``).  bf16 rounds at different places in the two (the
    kernel keeps its products and probabilities in float32 and sums in its
    own order), so they are held to the CPU tests' bounds: the loss within
    ``launch.serve.prefill_bound`` relative, every gradient leaf within
    sqrt(2) times it relative L2 (the backward rounds at as many places
    again)."""
    import math
    from repro_torch.launch.serve import prefill_bound
    from repro_torch.train import accumulate_grads
    loss_k, g_k = accumulate_grads(model, batch, cfg)
    with plain_ctx:
        loss_p, g_p = accumulate_grads(model, batch, cfg)
    bound = prefill_bound(cfg)
    loss_k, loss_p = float(loss_k), float(loss_p)
    rel = {n: float((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30))
           for n in g_p}
    finite = math.isfinite(loss_k) and all(
        bool(torch.isfinite(g).all()) for g in g_k.values())
    worst = max(rel, key=rel.get)
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "loss_bound": bound, "grad_rel_l2_max": rel[worst],
           "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_median": sorted(rel.values())[len(rel) // 2],
           "grad_bound": math.sqrt(2) * bound}
    del g_k, g_p
    if not (finite and out["loss_rel"] <= bound
            and out["grad_rel_l2_max"] <= out["grad_bound"]):
        raise AssertionError(f"step 0 through the kernels vs plain: {out}")
    print(f"step 0 ({cfg.name}): loss {loss_k:.6f} through the kernels, "
          f"{loss_p:.6f} plain (rel {out['loss_rel']:.2e}, bound "
          f"{bound:.4f}); gradients rel L2 max {rel[worst]:.3e} ({worst}), "
          f"median {out['grad_rel_l2_median']:.3e} (bound "
          f"{out['grad_bound']:.4f})")
    return out


def train_profile(torch, cfg, model, ds, vid, seed: int, label: str) -> dict:
    """Where a training step's time goes: a fresh AdamW, one warm-up step
    and one step under torch.profiler (the corpus's next two batches):
    wall ms, device busy ms and share, the device ms inside the step's
    forward, backward (remat's recompute included) and optimizer ranges,
    and the model kernels' device ms by name.  The trace is read and
    deleted."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import AdamW, cosine_schedule, make_train_step
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=10, total=TRAIN_STEPS))
    state = opt.init(model)
    step = make_train_step(cfg, opt)
    batches = list(ds.batches(vid=vid, global_batch=TRAIN_BATCH,
                              seed=seed + 1, start_step=TRAIN_STEPS,
                              n_steps=2))
    model, state, m = step(model, state, batches[0])
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state, m = step(model, state, batches[1])
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, rows = trace_device_time(prof, label)
    ranges = trace_ranges(label, TRAIN_RANGES)
    (ROOT / "chiprun_out" / f"chip_smoke_trace_{label}.json").unlink()
    own = {key: [(ms, k) for name, ms, k in rows if key in name]
           for key in MODEL_KERNEL_NAMES}
    own = {key: (sum(ms for ms, _ in hits), sum(k for _, k in hits))
           for key, hits in own.items() if hits}
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "ranges": {k: {"ms": r["ms"], "launches": r["launches"],
                          "by_kernel": r["by_kernel"]}
                      for k, r in ranges.items()},
           "model_kernels": own, "device_ms_by_op": rows[:12]}
    print(f"profile ({label}, one step): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); "
          + ", ".join(f"{k.split('.')[1]} {r['ms']:.1f} ms device in "
                      f"{r['launches']} launches" for k, r in ranges.items()))
    for key, (ms, k) in own.items():
        print(f"  model kernel {key}: {ms:.3f} ms in {k} launches "
              f"({100 * ms / busy_ms:.1f}% of the device time)")
    for name, ms, _ in rows[:8]:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    return out


BWD_CELL_SHAPE = (8, 4096, 16, 8, 128)   # the train-4k cell's call


def flash_backward_timing(torch, seed: int) -> dict:
    """The flash Function's two halves at the training shape (InternLM2's
    attention: B 8, S 256, 16 / 8 heads of 128, bf16, causal) and at the
    train-4k cell's call (``BWD_CELL_SHAPE``): the backward kernel's dq,
    dk and dv (``fa.flash_backward``) against the plain-torch backward's
    (``ops._flash_bwd``, float32) from the same q, k, v, o, dO within
    ``BWD_TOL`` relative L2 each, or the phase fails; then the forward
    kernel's launch (with the lse it writes for the backward), the
    backward kernel beside its bound, the plain backward (its lse stream
    included), and ``scaled_dot_product_attention``'s backward through
    autograd (CUDA events; the library's time, a yardstick the port never
    calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def one(shape, plain_reps: int) -> dict:
        b, s, h, hkv, dh = shape
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
        q, k, v, do = (torch.randn(sh, generator=gen, device=DEVICE,
                                   dtype=torch.bfloat16)
                       for sh in ((b, s, h, dh), (b, s, hkv, dh),
                                  (b, s, hkv, dh), (b, s, h, dh)))
        o, lse = fa.flash_attention(q, k, v, True, lse=True)
        before = fa.BWD_LAUNCHES
        got = fa.flash_backward(q, k, v, o, do, lse, True)
        launches = fa.BWD_LAUNCHES - before
        want = ops._flash_bwd(q, k, v, o, do, True)
        rel = {n: float((g.float() - w.float()).norm() / w.float().norm())
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        del got, want
        if launches != 1 or max(rel.values()) > BWD_TOL:
            raise AssertionError(f"flash backward at {list(shape)}: "
                                 f"{launches} launches, rel L2 {rel} "
                                 f"(bound {BWD_TOL})")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        pairs = s * (s + 1) // 2
        out = {"shape": list(shape), "dtype": "torch.bfloat16",
               "launches": launches, "rel_l2_vs_plain": rel,
               "max_abs_err": err, "rel_l2_bound": BWD_TOL,
               "forward_kernel_ms": cuda_ms(torch, lambda: fa._launch(
                   q, k, v, True), 10),
               "forward_lse_ms": cuda_ms(torch, lambda: fa.flash_attention(
                   q, k, v, True, lse=True), 10),
               "backward_kernel_ms": cuda_ms(torch, lambda: fa.flash_backward(
                   q, k, v, o, do, lse, True), 10),
               "backward_plain_ms": cuda_ms(torch, lambda: ops._flash_bwd(
                   q, k, v, o, do, True), plain_reps),
               "library_bwd_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                   lib_out, (qt, kt, vt), do.transpose(1, 2),
                   retain_graph=True), 10),
               # the kernel's five products over the pairs the mask keeps
               "backward_operations": 10 * b * h * dh * pairs,
               # q, k, v, o, dO read, dq, dk, dv written, the lse and delta
               "backward_bytes": 2 * (4 * b * s * h * dh + 4 * b * s * hkv
                                      * dh) + 8 * b * h * s}
        ops_ms = 1e3 * out["backward_operations"] / BF16_OPS_PER_S
        bytes_ms = 1e3 * out["backward_bytes"] / HBM_BYTES_PER_S
        out["backward_bound_ms"] = max(ops_ms, bytes_ms)
        out["backward_bound_by"] = "bytes" if bytes_ms >= ops_ms else \
            "operations"
        out["backward_roofline_pct"] = 100 * out["backward_bound_ms"] / \
            out["backward_kernel_ms"]
        out["backward_over_forward"] = (out["backward_kernel_ms"]
                                        / out["forward_kernel_ms"])
        rels = ", ".join(f"{n} {r:.2e}" for n, r in rel.items())
        print(f"flash at {list(shape)} bf16: backward kernel vs the plain "
              f"backward rel L2 {rels} (bound {BWD_TOL:.2e}), max abs "
              f"{err:.3e}; forward kernel "
              f"{out['forward_kernel_ms']:.4f} ms (with the lse "
              f"{out['forward_lse_ms']:.4f}), backward kernel "
              f"{out['backward_kernel_ms']:.4f} ms (bound "
              f"{out['backward_bound_ms']:.4f}, "
              f"{out['backward_roofline_pct']:.1f}%), plain-torch backward "
              f"{out['backward_plain_ms']:.4f} ms, scaled_dot_product_"
              f"attention backward {out['library_bwd_ms']:.4f} ms")
        return out

    out = one((TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128), 5)
    out["cell"] = one(BWD_CELL_SHAPE, 2)
    return out


def train_checks(cfg, runs: list, n_steps: int) -> None:
    """Every loss and grad norm of ``runs`` finite, and the right number of
    them."""
    import math
    got = sum(len(r["losses"]) for r in runs)
    values = [x for r in runs for x in r["losses"] + r["grad_norms"]]
    if got != n_steps or not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{cfg.name}: {got} of {n_steps} steps, or a "
                             f"non-finite loss or grad norm: {values}")


def phase_train_dense(torch, np, seed: int, report: dict) -> None:
    """Phase 18: InternLM2-1.8B training at full size through the port's
    train launcher (``repro_torch.launch.train``)."""
    import shutil
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.models import init_params
    from repro_torch.train import CheckpointStore
    cfg = configs.get(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    ds, vid = T.corpus(cfg, seq=TRAIN_SEQ, seed=seed, device=DEVICE)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE, trainable=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch0 = next(ds.batches(vid=vid, global_batch=TRAIN_BATCH,
                             seed=seed + 1, n_steps=1))
    check = step0_check(torch, cfg, model, batch0, plain_flash(torch))
    gc.collect()
    torch.cuda.empty_cache()
    common = dict(batch=TRAIN_BATCH, seed=seed, steps=TRAIN_STEPS)
    zero_launch_counts()                      # the training path's window
    whole = T.train(cfg, model, ds, vid, store=None, start=0,
                    parent_vid=None, **common)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = ROOT / "build" / "train_ckpt_phase18"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        store = CheckpointStore(str(ckpt_dir), shard_rows=1 << 12)
        model, start, parent = T.restore_or_init(cfg, store, seed=seed,
                                                 device=DEVICE)
        first = T.train(cfg, model, ds, vid, store=store, start=start,
                        parent_vid=parent, ckpt_every=TRAIN_PREEMPT,
                        preempt_after=TRAIN_PREEMPT, **common)
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        del model, store                      # the trainer is gone
        gc.collect()
        torch.cuda.empty_cache()
        disk_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
        t0 = time.perf_counter()
        store = CheckpointStore(str(ckpt_dir), shard_rows=1 << 12)
        open_s = time.perf_counter() - t0
        model, start, parent = T.restore_or_init(cfg, store, seed=seed,
                                                 device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bitexact = all(torch.equal(p, saved[n])
                       for n, p in model.named_parameters())
        del saved, store
        second = T.train(cfg, model, ds, vid, store=None, start=start,
                         parent_vid=parent, **common)
        launches = launch_counts()            # the window closes
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    train_checks(cfg, [whole], TRAIN_STEPS)
    train_checks(cfg, [first, second], TRAIN_STEPS)
    if (start, parent) != (TRAIN_PREEMPT, first["checkpoints"][0]["vid"]):
        raise AssertionError(f"resumed at step {start} from v{parent}")
    if not bitexact:
        raise AssertionError("the restored parameters differ from the saved")
    replay = [bool(np.array_equal(a, b)) for a, b in
              zip(first["tokens"] + second["tokens"], whole["tokens"])]
    if not all(replay):
        raise AssertionError(f"the interrupted run's batches differ: {replay}")
    rerun = [abs(a - b) / abs(b) for a, b in zip(first["losses"],
                                                 whole["losses"])]
    if max(rerun) > RERUN_LOSS_RTOL:
        raise AssertionError(f"the interrupted run's first losses differ "
                             f"from the uninterrupted run's: {rerun}")
    n_steps = TRAIN_STEPS + TRAIN_PREEMPT + len(second["losses"])
    want = n_steps * cfg.n_layers * (2 if cfg.remat else 1)
    if (launches["flash_attention"] != want or launches["ssd_scan"]
            or launches["flash_backward"] != n_steps * cfg.n_layers
            or launches["gather_row_tiles"] < 3):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want} flash_attention (the forward and "
                             f"remat's recompute of {n_steps} steps) and "
                             f"{n_steps * cfg.n_layers} flash_backward")
    profile = train_profile(torch, cfg, model, ds, vid, seed,
                            "train_internlm2")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    bwd = flash_backward_timing(torch, seed)
    ckpt = first["checkpoints"][0]
    ms_step = 1e3 * float(np.mean(whole["step_s"][1:]))
    report["train_dense"] = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
        "step0": check, "whole": {k: whole[k] for k in ("losses",
                                                        "grad_norms",
                                                        "step_s")},
        "first": {k: first[k] for k in ("losses", "grad_norms", "step_s")},
        "second": {k: second[k] for k in ("losses", "grad_norms", "step_s")},
        "ms_per_step": ms_step, "rerun_loss_rel": rerun,
        "save_s": ckpt["save_s"], "checkpoint_bytes": ckpt["bytes"],
        "disk_bytes": disk_bytes, "open_s": open_s, "restore_s": restore_s,
        "launches": launches, "profile": profile,
        "peak_memory_bytes": peak, "flash_backward": bwd}
    print(f"train (dense): {cfg.name} ({n_params:,} params, remat "
          f"{cfg.remat}) made in {init_s:.1f} s; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}; {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in whole['losses']]}, grad norms "
          f"{[round(x, 3) for x in whole['grad_norms']]}; "
          f"{ms_step:.1f} ms a step after the first "
          f"({1e3 * whole['step_s'][0]:.1f} ms)")
    print(f"interrupted run: {TRAIN_PREEMPT} steps, checkpoint "
          f"v{ckpt['vid']} saved in {ckpt['save_s']:.1f} s "
          f"({ckpt['bytes'] / 1e9:.2f} GB of float32, {disk_bytes / 1e9:.2f} "
          f"GB on disk), trainer dropped, store reopened in {open_s:.1f} s, "
          f"restored at step {start} in {restore_s:.1f} s (bit-exact "
          f"{bitexact}), {len(second['losses'])} more steps: losses "
          f"{[round(x, 4) for x in first['losses'] + second['losses']]}; "
          f"batches replayed {replay}; first losses vs the uninterrupted "
          f"run's rel {[f'{r:.1e}' for r in rerun]}")
    print(f"training launches {launches}; peak device memory "
          f"{peak / 1e9:.2f} GB")


def phase_train_ssm(torch, np, seed: int, report: dict) -> None:
    """Phase 19: Mamba2-780M training at full size, two microbatches a
    step, through the same launcher."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train as T
    from repro_torch.models import init_params
    cfg = configs.get(TRAIN_SSM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    ds, vid = T.corpus(cfg, seq=TRAIN_SEQ, seed=seed, device=DEVICE)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE, trainable=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch0 = next(ds.batches(vid=vid, global_batch=TRAIN_BATCH,
                             seed=seed + 1, n_steps=1))

    def plain_scan(xs, bmat, cmat, dt, a, chunk=256):
        ss.check_operands(xs, bmat, cmat, dt, a, chunk)
        return ss.ssd_scan_plain(xs, bmat, cmat, dt, a, chunk)

    check = step0_check(torch, cfg, model, batch0,
                        swap_plain(ss, "ssd_scan", plain_scan))
    gc.collect()
    torch.cuda.empty_cache()
    zero_launch_counts()                      # the training path's window
    run = T.train(cfg, model, ds, vid, store=None, start=0, parent_vid=None,
                  batch=TRAIN_BATCH, seed=seed, steps=TRAIN_SSM_STEPS)
    launches = launch_counts()                # the window closes
    train_checks(cfg, [run], TRAIN_SSM_STEPS)
    want = (TRAIN_SSM_STEPS * cfg.microbatches * cfg.n_layers
            * (2 if cfg.remat else 1))
    if launches["ssd_scan"] != want or launches["gather_row_tiles"] < 1 \
            or launches["flash_attention"]:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want} ssd_scan")
    profile = train_profile(torch, cfg, model, ds, vid, seed, "train_mamba2")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    report["train_ssm"] = {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "microbatches": cfg.microbatches, "remat": cfg.remat,
        "step0": check, "losses": run["losses"],
        "grad_norms": run["grad_norms"], "step_s": run["step_s"],
        "launches": launches, "profile": profile, "peak_memory_bytes": peak}
    print(f"train (ssm): {cfg.name} ({n_params:,} params, "
          f"{cfg.microbatches} microbatches of "
          f"{TRAIN_BATCH // cfg.microbatches}, remat {cfg.remat}) made in "
          f"{init_s:.1f} s; "
          f"{TRAIN_SSM_STEPS} steps, losses "
          f"{[round(x, 4) for x in run['losses']]}, grad norms "
          f"{[round(x, 3) for x in run['grad_norms']]}, "
          f"{[round(1e3 * x, 1) for x in run['step_s']]} ms; launches "
          f"{launches}; peak device memory {peak / 1e9:.2f} GB")


# phase 23: the compile analysis.  The grid's meta traces are host work:
# they run in DRYRUN_WORKERS background processes started after the build,
# at the lowest priority, and phase 23 collects them; the three measured
# cells are the one-card sizes phases 12, 15 and 18 run
MESH_STEPS = 3                    # phase 24's compressed steps
RESIDUAL_TOL = 1e-3               # a residual's agreement, in its scale
HALF_POINT = 1e-3                 # a flip's distance from a half-point
FLIP_SHARE = 0.01                 # flips a leaf may hold
MESH_LOSS_RTOL = 1e-6             # the step's first loss vs the plain one
E_SLACK = 127 * 2.0 ** -23        # |e| / s past 1/2: q·s rounds in float32


def residual_check(torch, ef, g_host: dict, amax: dict) -> dict:
    """The compressed step's residuals after one step from zero against
    ``g − round(g/s)·s`` in plain torch, ``g`` a parameter's gradient by
    ``accumulate_grads`` on the same weights and batch (kept on the host)
    and ``s`` the scale of its reference leaf (a stack's layers share
    theirs: the leaf's largest |g| / 127 + 1e-12, as ``quantize_int8``).
    The embedding's backward adds with atomics, so ``g`` differs from the
    step's in its last bits: an element's ``q`` may flip where ``g / s``
    lies at a rounding half-point.  Away from flips the residual agrees
    within ``RESIDUAL_TOL`` of ``s``; every flip lies within
    ``HALF_POINT`` of a half-point, and flips are at most ``FLIP_SHARE``
    of a leaf.  Every residual holds ``|e| ≤ s/2`` but for ``E_SLACK``
    of ``s`` (``target − q·s`` rounds q·s, up to 127 s, in float32)."""
    from repro_torch.models.convert import reference_path
    from repro_torch.sharding import local
    groups: dict = {}
    for n, a in amax.items():
        path = reference_path(n)
        groups[path] = torch.maximum(groups[path], a) if path in groups \
            else a
    out = {"leaves": 0, "flips": 0, "worst_rel": 0.0, "max_e_over_s": 0.0}
    for n, g in g_host.items():
        s = groups[reference_path(n)] / 127.0 + 1e-12
        g = g.to(DEVICE)
        want = g - torch.round(g / s) * s
        e = local(ef[n])[0]
        diff = (e - want).abs()
        flip = diff > 0.5 * s
        frac = (g / s)[flip]
        near = ((frac - torch.floor(frac)) - 0.5).abs()
        rest = diff[~flip]
        worst = float(rest.max() / s) if rest.numel() else 0.0
        e_over_s = float(e.abs().max() / s)
        n_flip = int(flip.sum())
        if (worst > RESIDUAL_TOL or bool((near > HALF_POINT).any())
                or n_flip > max(1, FLIP_SHARE * e.numel())
                or e_over_s > 0.5 + E_SLACK):
            raise AssertionError(f"{n}: residual off by {worst:.2e} of its "
                                 f"scale, {n_flip} flips, |e|/s "
                                 f"{e_over_s:.6f}")
        out["leaves"] += 1
        out["flips"] += n_flip
        out["worst_rel"] = max(out["worst_rel"], worst)
        out["max_e_over_s"] = max(out["max_e_over_s"], e_over_s)
        del g, want, e, diff
    return out


def phase_train_compressed(torch, np, seed: int, gpu: str,
                           report: dict) -> None:
    """Phase 24: InternLM2-1.8B at full size on a one-rank NCCL mesh
    through the compressed train step, its residuals held against a plain
    recomputation, and an elastic restore onto the mesh."""
    import shutil
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, local, make_ctx, whole
    from repro_torch.train import (AdamW, CheckpointStore, accumulate_grads,
                                   cosine_schedule, ef_init, ef_specs,
                                   elastic_reshard, make_train_step)
    cfg = configs.get(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), DEVICE)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if dist.get_backend() != backend:
        raise AssertionError(f"the mesh's group is {dist.get_backend()}, "
                             f"not {backend}")
    ctx = make_ctx(mesh)
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE, trainable=True)
    rng = np.random.default_rng(seed + 24)
    batches = []
    for _ in range(MESH_STEPS):
        toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)
                            ).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    # g and the plain loss, apart from the step, on the same weights and
    # the first batch; g waits on the host
    loss_plain, g = accumulate_grads(model, batches[0], cfg)
    loss_plain = float(loss_plain)
    amax = {n: t.abs().max() for n, t in g.items()}
    g_host = {n: t.detach().cpu() for n, t in g.items()}
    del g
    gc.collect()
    torch.cuda.empty_cache()
    distribute(model, param_specs(cfg), mesh)
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=10, total=TRAIN_STEPS))
    state = opt.init(model)
    ef = ef_init(model, 1, ctx)
    step = make_train_step(cfg, opt, grad_compress=True, ctx=ctx)
    ef_bytes = sum(4 * e.numel() for e in ef.values())
    losses, norms, step_s = [], [], []
    zero_launch_counts()                      # the compressed path's window
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, ef, m = step(model, state, ef, b)
        losses.append(float(m["loss"]))       # waits for the step
        step_s.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        if i == 0:                            # plain torch: no kernel
            check = residual_check(torch, ef, g_host, amax)
            del g_host, amax
    launches = launch_counts()                # the window closes
    peak = torch.cuda.max_memory_allocated()
    loss_rel = abs(losses[0] - loss_plain) / abs(loss_plain)
    want = MESH_STEPS * cfg.n_layers * (2 if cfg.remat else 1)
    if loss_rel > MESH_LOSS_RTOL or not all(
            math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"compressed step losses {losses} (plain "
                             f"{loss_plain}), grad norms {norms}")
    if launches["flash_attention"] != want or launches["ssd_scan"]:
        raise AssertionError(f"compressed training launches {launches}, "
                             f"expected {want} flash_attention")
    # the one-device state of layer 0 and the final norm, onto the mesh
    names = [n for n, _ in model.named_parameters()
             if n.startswith("layers.0.") or n == "final_norm"]
    one = {"params": {n: local(dict(model.named_parameters())[n]).detach()
                      .clone() for n in names},
           "ef": {n: local(ef[n]).clone() for n in names}}
    specs = {n: param_specs(cfg)[n] for n in names}
    ckpt_dir = ROOT / "build" / "mesh_ckpt_phase24"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        store = CheckpointStore(str(ckpt_dir), shard_rows=1 << 12)
        vid = store.save(step=MESH_STEPS, tree=one, meta={"cursor": 3})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = elastic_reshard(store, vid, mesh,
                               {"params": specs, "ef": ef_specs(specs)},
                               treedef_like=one)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        bitexact = all(
            torch.equal(whole(back[k][n]), one[k][n])
            and back[k][n].device_mesh == mesh for k in one for n in names)
        ckpt_bytes = sum(4 * t.numel() for k in one for t in one[k].values())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not bitexact:
        raise AssertionError("elastic_reshard onto the NCCL mesh differs "
                             "from the saved state")
    ms_step = 1e3 * float(np.mean(step_s[1:]))
    plain_ms = report.get("train_dense", {}).get("ms_per_step")
    report["train_compressed"] = {
        "arch": cfg.name, "mesh": mesh_shape(mesh), "backend": backend,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MESH_STEPS,
        "losses": losses, "grad_norms": norms, "step_s": step_s,
        "loss_plain": loss_plain, "loss_rel": loss_rel,
        "residuals": check, "ms_per_step": ms_step,
        "plain_step_ms_phase18": plain_ms, "residual_bytes": ef_bytes,
        "peak_memory_bytes": peak, "launches": launches,
        "reshard": {"leaves": 2 * len(names), "bytes": ckpt_bytes,
                    "save_s": save_s, "reshard_s": reshard_s,
                    "bitexact": bitexact}, "gpu": gpu}
    del model, state, ef, back, one, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"mesh: {mesh_shape(mesh)} over one {backend} rank; {cfg.name} "
          f"through "
          f"the compressed step, {MESH_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: losses {[round(x, 4) for x in losses]} (the first "
          f"vs the plain loss rel {loss_rel:.1e}), grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"residuals vs g - round(g/s)*s: {check['leaves']} leaves, "
          f"{check['flips']} flips, worst {check['worst_rel']:.2e} of s "
          f"elsewhere, max |e|/s {check['max_e_over_s']:.6f}; elastic "
          f"restore of {2 * len(names)} leaves ({ckpt_bytes / 1e6:.0f} MB) "
          f"onto the mesh bit-exact {bitexact} (save {save_s:.1f} s, "
          f"restore {reshard_s:.1f} s)")
    print(f"compressed step {ms_step:.1f} ms after the first "
          f"({1e3 * step_s[0]:.1f} ms), phase 18's plain step "
          f"{plain_ms if plain_ms is None else round(plain_ms, 1)} ms; "
          f"residuals {ef_bytes / 1e9:.2f} GB; peak device memory "
          f"{peak / 1e9:.2f} GB; launches {launches}; {gpu}")


# phase 25: the model axis (tensor and expert parallelism) on one NCCL rank
TP_STEPS = 2                      # plain steps through the TP/EP path
TP_RTOL = 1e-5                    # its first loss and grad norm vs ctx=None
TP_RESHARD_LAYER = "layers.0.moe."  # model layer 1: the first MoE layer


def expected_tp_calls(cfg, steps: int, m: int = 1) -> dict:
    """The model group's collectives ``steps`` plain steps of ``cfg`` (a
    latent-attention MoE stack with shared experts, S divisible by the
    model axis ``m``, the heads split over it) issue, by
    ``sharding.TP_CALLS`` kind, a microbatch each.  On an axis of 1 (the
    residual whole): ``copy_to_tp``'s all-reduces run in the backward
    (latent attention: ``wq`` and the latent; a SwiGLU or shared expert:
    ``wi`` and ``wg``; an MoE layer's router) and so do ``split_seq``'s
    all-gathers; ``reduce_from_tp`` (each attention's and SwiGLU's
    ``wo``), ``gather_seq`` and an MoE layer's two all-to-alls run in the
    forward, the all-to-alls once each again in the backward.  Above 1
    (the residual the rank's sequence rows, the vocabulary sharded): the
    embedding's reduce-scatter, each attention's and each SwiGLU's or
    shared expert's gather in and reduce-scatter out, and the head's
    gather, each once forward and once backward; ``copy_to_tp`` for every
    norm's scale on the rows, each latent and each router; the two
    all-to-alls each way; the cross-entropy's ``vocab_max`` and
    ``vocab_sum`` once.  Remat's recompute counts apart
    (``sharding.TP_RECOMPUTE``): where torch stops it differs between
    builds and devices."""
    from repro_torch.sharding import TP_CALLS
    if cfg.attn_type != "mla" or not cfg.moe.n_shared:
        raise ValueError(f"{cfg.name}: the reckoning is for latent "
                         "attention and shared experts")
    n_moe = cfg.n_layers - cfg.first_dense
    per_mb = dict.fromkeys(TP_CALLS, 0)
    if m == 1:
        per_mb.update({"copy_to_tp": 4 * cfg.first_dense + 5 * n_moe,
                       "reduce_from_tp": 2 * cfg.n_layers,
                       "split_seq": n_moe, "gather_seq": n_moe,
                       "all_to_all": 4 * n_moe})
    else:
        both = 2 * (2 * cfg.n_layers + 1)
        per_mb.update({"copy_to_tp": 3 * cfg.n_layers + n_moe + 1,
                       "all_gather_seq": both, "reduce_scatter_seq": both,
                       "all_to_all": 4 * n_moe, "vocab_max": 1,
                       "vocab_sum": 1})
    n = steps * max(cfg.microbatches, 1)
    return {k: n * v for k, v in per_mb.items()}


def phase_train_tp(torch, np, seed: int, gpu: str, report: dict) -> None:
    """Phase 25: DeepSeek-V2-Lite at full width and ``MLA_DEPTH`` layers
    (latent attention, the dense SwiGLU layer, 3 MoE layers with shared
    experts) through the tensor- and expert-parallel train step on a
    one-rank NCCL ("data", "model") mesh, against the one-device step
    (``ctx=None``) on the same weights and batches; the model group's
    collectives counted; an elastic restore of the first MoE layer's
    leaves onto the mesh.  One card holds one NCCL rank, so the numerics
    across model ranks are held on the CPU by gloo ranks
    (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_expert_parallel.py``), as the reference holds its
    own on faked host devices."""
    import shutil
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.models import init_params
    from repro_torch.models.transformer import count_params, param_specs
    from repro_torch.sharding import (TP_CALLS, TP_RECOMPUTE, distribute,
                                      local, make_ctx, whole, zero_tp_calls)
    from repro_torch.train import (AdamW, CheckpointStore, cosine_schedule,
                                   elastic_reshard, make_train_step)
    cfg = dataclasses.replace(configs.get(MLA_ARCH), n_layers=MLA_DEPTH)
    rng = np.random.default_rng(seed + 25)
    batches = []
    for _ in range(TP_STEPS):
        toks = rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1)
                            ).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})

    def run(ctx, mesh):
        """TP_STEPS steps from the seeded weights: (losses, grad norms,
        step seconds, launches, collectives, peak bytes, the model)."""
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
            seed), DEVICE, trainable=True)
        if mesh is not None:
            distribute(model, param_specs(cfg), mesh)
        opt = AdamW(lr=cosine_schedule(3e-4, warmup=10, total=TRAIN_STEPS))
        state = opt.init(model)
        step = make_train_step(cfg, opt, ctx=ctx)
        losses, norms, step_s = [], [], []
        zero_launch_counts()                  # the path's window
        zero_tp_calls()
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step(model, state, b)
            losses.append(float(m["loss"]))   # waits for the step
            step_s.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
        out = (losses, norms, step_s, launch_counts(), dict(TP_CALLS),
               dict(TP_RECOMPUTE), torch.cuda.max_memory_allocated())
        del state, step
        return out, model

    (p_losses, p_norms, p_s, p_launches, p_calls, _, p_peak), model = run(
        None, None)
    n_params = count_params(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if dist.get_backend() != backend:
        raise AssertionError(f"the mesh's group is {dist.get_backend()}, "
                             f"not {backend}")
    ctx = make_ctx(mesh)
    (losses, norms, step_s, launches, calls, recomputed, peak), model = run(
        ctx, mesh)
    loss_rel = abs(losses[0] - p_losses[0]) / abs(p_losses[0])
    norm_rel = abs(norms[0] - p_norms[0]) / abs(p_norms[0])
    want_calls = expected_tp_calls(cfg, TP_STEPS)
    want_flash = (TP_STEPS * max(cfg.microbatches, 1) * cfg.n_layers
                  * (2 if cfg.remat else 1))
    if (loss_rel > TP_RTOL or norm_rel > TP_RTOL
            or not all(math.isfinite(x) for x in losses + norms)):
        raise AssertionError(f"TP/EP step losses {losses}, grad norms "
                             f"{norms}; ctx=None {p_losses}, {p_norms}")
    if calls != want_calls or any(p_calls.values()):
        raise AssertionError(f"the model group's collectives {calls}, "
                             f"expected {want_calls} (ctx=None: {p_calls})")
    if launches["flash_attention"] != want_flash or launches["ssd_scan"] \
            or p_launches["flash_attention"] != want_flash:
        raise AssertionError(f"TP/EP training launches {launches} "
                             f"(ctx=None {p_launches}), expected "
                             f"{want_flash} flash_attention")
    # the first MoE layer's leaves, saved from the one-rank state and
    # restored onto the mesh
    named = dict(model.named_parameters())
    names = [n for n in named if n.startswith(TP_RESHARD_LAYER)]
    one = {n: local(named[n]).detach().clone() for n in names}
    specs = {n: param_specs(cfg)[n] for n in names}
    ckpt_dir = ROOT / "build" / "mesh_ckpt_phase25"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        store = CheckpointStore(str(ckpt_dir), shard_rows=1 << 12)
        vid = store.save(step=TP_STEPS, tree=one, meta={"cursor": TP_STEPS})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = elastic_reshard(store, vid, mesh, specs, treedef_like=one)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        bitexact = all(torch.equal(whole(back[n]), one[n])
                       and back[n].device_mesh == mesh for n in names)
        ckpt_bytes = sum(4 * t.numel() for t in one.values())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not bitexact:
        raise AssertionError("elastic_reshard of the MoE leaves onto the "
                             "NCCL mesh differs from the saved state")
    ms_step = 1e3 * float(np.mean(step_s[1:]))
    plain_ms = 1e3 * float(np.mean(p_s[1:]))
    report["train_tp"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "mesh": mesh_shape(mesh), "backend": backend,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS,
        "microbatches": cfg.microbatches, "losses": losses,
        "grad_norms": norms, "step_s": step_s, "plain_losses": p_losses,
        "plain_grad_norms": p_norms, "plain_step_s": p_s,
        "loss_rel": loss_rel, "norm_rel": norm_rel, "rtol": TP_RTOL,
        "tp_calls": calls, "tp_recompute": recomputed,
        "ms_per_step": ms_step,
        "plain_ms_per_step": plain_ms, "peak_memory_bytes": peak,
        "plain_peak_memory_bytes": p_peak, "launches": launches,
        "reshard": {"leaves": len(names), "bytes": ckpt_bytes,
                    "save_s": save_s, "reshard_s": reshard_s,
                    "bitexact": bitexact}, "gpu": gpu}
    del model, named, one, back
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"model axis: {mesh_shape(mesh)} over one {backend} rank; "
          f"{cfg.name} at {cfg.n_layers} layers ({n_params / 1e9:.2f} B "
          f"parameters) through the TP/EP step, {TP_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {cfg.microbatches} microbatches: "
          f"losses {[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; ctx=None {[round(x, 5) for x in p_losses]}, "
          f"{[round(x, 4) for x in p_norms]} (first loss rel {loss_rel:.1e}, "
          f"grad norm rel {norm_rel:.1e}, tolerance {TP_RTOL})")
    print(f"model-group collectives {calls} (as reckoned), remat's "
          f"recompute {recomputed}; flash launches "
          f"{launches['flash_attention']}; elastic restore of "
          f"{len(names)} MoE leaves ({ckpt_bytes / 1e9:.2f} GB) onto the "
          f"mesh bit-exact {bitexact} (save {save_s:.1f} s, restore "
          f"{reshard_s:.1f} s)")
    print(f"TP/EP step {ms_step:.1f} ms after the first "
          f"({1e3 * step_s[0]:.1f} ms), ctx=None step {plain_ms:.1f} ms "
          f"({1e3 * p_s[0]:.1f} ms); peak device memory {peak / 1e9:.2f} GB "
          f"(ctx=None {p_peak / 1e9:.2f} GB); {gpu}")


MESH_SERVE_BATCH = 4              # phase 26 (a): 4 prompts of 512
MESH_SERVE_PROMPT = 512           # tokens through the mesh prefill, then
MESH_SERVE_DECODE = 8             # 8 decodes from a cache of 512 positions
MESH_SERVE_SLOTS = 528            # (its slots a multiple of 16)
MESH_MODEL_AXIS = 16              # phase 26 (b): the production model axis
SEQ_SHARD_SHAPE = (1, 4096, 56, 8, 128)   # LLaVA-NeXT-34B: B, S, H, Hkv, Dh
DECODE_MERGE_SHAPE = (4, 4096, 56, 8, 128)  # its decode at a 4096 cache
PART_RTOL = 1e-5                  # float32 sums of the parts, another order


def expected_serve_calls(cfg, decode_steps: int) -> dict:
    """The model group's collectives of one mesh prefill and
    ``decode_steps`` decodes of a hybrid whose kv heads split over the
    axis, by ``sharding.TP_CALLS`` kind (nothing is differentiated, so
    only the forwards count): a prefill's SSD layer sums its norm's
    squares (``norm_sum``) and reduces after ``out_proj``; each
    shared-block application reduces after attention's ``wo`` and the
    SwiGLU's; a decode adds, in each SSD layer, the x row's gather and, in
    each application, the q/k/v gather and the merge (one ``decode_max``,
    two ``decode_sum``)."""
    from repro_torch.sharding import TP_CALLS
    n_ssd = cfg.n_layers
    n_attn = cfg.n_layers // cfg.shared_every
    steps = 1 + decode_steps
    out = dict.fromkeys(TP_CALLS, 0)
    out["reduce_from_tp"] = steps * (n_ssd + 2 * n_attn)
    out["norm_sum"] = steps * n_ssd
    out["gather_seq"] = decode_steps * (n_ssd + n_attn)
    out["decode_max"] = decode_steps * n_attn
    out["decode_sum"] = 2 * decode_steps * n_attn
    return out


def mesh_serve_cache(torch, cfg, seed: int) -> dict:
    """A whole decode cache of ``MESH_SERVE_SLOTS`` positions holding a
    prompt of ``MESH_SERVE_PROMPT`` (``len``): seeded values on the card,
    the KV leaves normal, the SSD states normal · 0.5."""
    from repro_torch.models.transformer import init_cache
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    cache = init_cache(cfg, MESH_SERVE_BATCH, MESH_SERVE_SLOTS,
                       fill_len=MESH_SERVE_PROMPT, device=DEVICE)
    for k, t in cache.items():
        if k != "len":
            t.copy_(torch.randn(t.shape, generator=g, device=DEVICE)
                    * (0.5 if k in ("h", "conv") else 1.0))
    return cache


def serve_run(torch, step_fns, model, tokens, cache, feed=None) -> dict:
    """The prefill on ``tokens``, then ``MESH_SERVE_DECODE`` decodes from
    ``cache`` from the prompt's last token, each step's token the argmax
    of the last (or, with ``feed``, that run's tokens, so that both runs
    decode the same inputs): the logits, the argmax tokens, and the host
    ms of the prefill and of a decode step (after the first)."""
    prefill, step = step_fns
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tok = tokens[:, -1:]
    logits, toks, step_ms = [], [], []
    for i in range(MESH_SERVE_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(model, {"tokens": tok, "cache": cache})
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg.float())
        toks.append(torch.argmax(lg[:, -1:], dim=-1).to(torch.int32))
        tok = toks[-1] if feed is None else feed[:, i:i + 1]
    return {"prefill": pre.float(), "logits": logits,
            "tokens": torch.cat(toks, dim=1), "prefill_ms": prefill_ms,
            "decode_ms": float(sum(step_ms[1:]) / max(len(step_ms) - 1, 1)),
            "cache": cache}


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_mesh_serve(torch, seed: int, gpu: str, report: dict) -> None:
    """Phase 26: the mesh's model axis, second half.  (a) Zamba2-2.7B whole
    (54 SSD layers and 9 shared-block applications at full width, seeded
    weights) served on one device (``ctx=None``) and then, on the same
    weights laid out by ``param_specs``, on a one-rank NCCL ("data",
    "model") = (1, 1) mesh: ``make_prefill_step`` on 4 × 512 seeded
    tokens and 8 ``make_serve_step`` decodes from a seeded cache of 512
    positions (``mesh_serve_cache``, cut by ``cache_specs`` through
    ``shard_cache``; each path's first calls untimed), the mesh path
    taking its SSD heads' split, the norm's
    ``norm_sum``, the q/k/v gather and the sequence-parallel decode merge
    on a one-rank group.  Checks: every logit finite; the mesh path's
    prefill and decode logits within ``launch.serve.prefill_bound`` (rel
    L2 a row) of the one-device path's: on one rank the prefill runs the
    same products and the decode differs only in its softmax, the merge's
    exp(l − max) / Σ against ``torch.softmax``'s kernel, whose last float32
    bits flip a few bf16 probabilities, a difference the 54 layers carry
    on (the same rounding gap the bound is drawn for; the phase reruns the
    mesh decode with the one-device core in place of the merge and reports
    that gap too); the greedy tokens
    equal where the top-2 gap is clear of the bound; the model group's
    collectives as ``expected_serve_calls`` reckons; 9 ``flash_attention``
    and 54 ``ssd_scan`` launches in the mesh path's window.  (b), run
    first on the plain weights: each rank's part at a model axis of 16,
    rank by rank on the card, combined as the
    collectives would: the sequence-sharded attention at LLaVA-NeXT-34B's
    shape (``SEQ_SHARD_SHAPE``; each rank 256 query rows against the whole
    K and V through ``layers.seq_rows_forward``) against the
    whole-sequence flash kernel, and its backward's parts (dQ's rows, the
    dK/dV partials summed) against the one-slice backward; Zamba2's first
    SSD layer at the long prefill's shape, 80 heads in 16 ``ssd_scan``
    launches of 5 against the whole launch's heads (bit-exact expected:
    the heads are independent) and the gated norm's sum of squares over
    the 16 slices against the whole; LLaVA's decode attention at a cache
    of 4096 cut into 16 slices (``layers.scores``/``decode_values``,
    merged) against the one-slice decode.  One card holds one NCCL rank,
    so the numerics across model ranks are held on the CPU by gloo ranks
    (``tests/test_torch_seq_parallel.py``,
    ``tests/test_torch_ssd_parallel.py``,
    ``tests/test_torch_mesh_serve.py``)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, mesh_shape
    from repro_torch.launch.serve import prefill_bound
    from repro_torch.kernels import ref
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import (cache_specs, count_params,
                                                param_specs, shard_cache)
    from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
    from repro_torch.sharding import (TP_CALLS, distribute, make_ctx,
                                      zero_tp_calls)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(MODEL_ARCH)
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        seed + 26), DEVICE)
    n_params = count_params(model)
    tokens = torch.randint(0, cfg.vocab, (MESH_SERVE_BATCH,
                                          MESH_SERVE_PROMPT),
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 27), device=DEVICE)
    whole = mesh_serve_cache(torch, cfg, seed + 28)

    def copy():
        return {k: (v.clone() if k != "len" else v) for k, v in whole.items()}

    plain = (make_prefill_step(cfg, device=DEVICE),
             make_serve_step(cfg, device=DEVICE))
    serve_run(torch, plain, model, tokens, copy())        # first calls
    one = serve_run(torch, plain, model, tokens, copy())
    del one["cache"]
    # (b) first, on the plain weights
    parts = mesh_rank_parts(torch, model, cfg, seed)
    gc.collect()
    torch.cuda.empty_cache()
    parts_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # (a) the same weights on a one-rank NCCL mesh
    mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if dist.get_backend() != backend:
        raise AssertionError(f"the mesh's group is {dist.get_backend()}, "
                             f"not {backend}")
    ctx = make_ctx(mesh)
    distribute(model, param_specs(cfg), mesh)
    on_mesh = (make_prefill_step(cfg, ctx, device=DEVICE),
               make_serve_step(cfg, ctx, device=DEVICE))
    # first calls (NCCL's communicator starts at the first collective)
    serve_run(torch, on_mesh, model, tokens, shard_cache(whole, cfg, ctx),
              feed=one["tokens"])
    cache = shard_cache(whole, cfg, ctx)
    specs = cache_specs(cfg, MESH_SERVE_BATCH)
    zero_launch_counts()                      # the mesh serve's window
    zero_tp_calls()
    run = serve_run(torch, on_mesh, model, tokens, cache,
                    feed=one["tokens"])
    launches = launch_counts()                # the window closes
    calls = dict(TP_CALLS)
    # where the decode's gap comes from: the same mesh decode with the
    # merge (one rank: its positions are all of them) replaced by the
    # one-device core
    with swap_plain(L, "merged_decode",
                    lambda q, k, v, q_pos, k_pos0, causal, tp:
                    ref.mha_ref(q, k, v, causal, q_pos)):
        probe = serve_run(torch, on_mesh, model, tokens,
                          shard_cache(whole, cfg, ctx), feed=one["tokens"])
    del whole
    want_calls = expected_serve_calls(cfg, MESH_SERVE_DECODE)
    want_launches = {"flash_attention": cfg.n_layers // cfg.shared_every,
                     "ssd_scan": cfg.n_layers}
    bound = prefill_bound(cfg)
    errs = {"prefill": max(rel_l2(a, b) for a, b in zip(
        run["prefill"][:, -1], one["prefill"][:, -1]))}
    errs["decode"] = max(rel_l2(a[:, -1][r], b[:, -1][r])
                         for a, b in zip(run["logits"], one["logits"])
                         for r in range(MESH_SERVE_BATCH))
    errs["decode_first"] = max(rel_l2(run["logits"][0][r, -1],
                                      one["logits"][0][r, -1])
                               for r in range(MESH_SERVE_BATCH))
    errs["decode_core_swapped"] = max(
        rel_l2(a[:, -1][r], b[:, -1][r])
        for a, b in zip(probe["logits"], one["logits"])
        for r in range(MESH_SERVE_BATCH))
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [run["prefill"], one["prefill"], *run["logits"],
                  *one["logits"]])
    # the greedy tokens, wherever the one-device path's top-2 gap is clear
    # of the bound (a choice the two roundings cannot flip)
    top = torch.stack([lg[:, -1] for lg in one["logits"]], 1).topk(2).values
    clear = (top[..., 0] - top[..., 1]) > 2 * bound * top.abs().amax(-1)
    agree = bool(((run["tokens"] == one["tokens"]) | ~clear).all())
    gapped = int(clear.sum())
    local = {k: list(t.shape) for k, t in run["cache"].items() if k != "len"}
    if not finite or errs["prefill"] > bound or errs["decode"] > bound:
        raise AssertionError(f"mesh serve vs one-device: {errs} (bound "
                             f"{bound:.4f}), finite {finite}")
    if not agree:
        raise AssertionError("mesh serve: a greedy token differs where the "
                             "top-2 gap is clear of the bound")
    if calls != want_calls:
        raise AssertionError(f"mesh serve collectives {calls}, expected "
                             f"{want_calls}")
    if any(launches[k] != want_launches.get(k, 0) for k in launches):
        raise AssertionError(f"mesh serve launches {launches}, expected "
                             f"{want_launches}")
    peak_a = torch.cuda.max_memory_allocated()
    del run["cache"], cache, probe
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report["mesh_serve"] = {
        "arch": cfg.name, "params": n_params, "mesh": mesh_shape(mesh),
        "backend": backend, "batch": MESH_SERVE_BATCH,
        "prompt": MESH_SERVE_PROMPT, "decode_steps": MESH_SERVE_DECODE,
        "cache_slots": MESH_SERVE_SLOTS, "cache_specs": specs,
        "local_cache": local, "rel_l2": errs, "bound": bound,
        "tokens_equal": bool(torch.equal(run["tokens"], one["tokens"])),
        "gap_clear_tokens": gapped, "tp_calls": calls,
        "launches": launches,
        "mesh_prefill_ms": run["prefill_ms"],
        "mesh_decode_ms": run["decode_ms"],
        "prefill_ms": one["prefill_ms"], "decode_ms": one["decode_ms"],
        "peak_memory_bytes": peak_a,
        "parts_peak_memory_bytes": parts_peak,
        "parts": parts, "seconds": time.perf_counter() - t_phase,
        "gpu": gpu}
    print(f"mesh serve: {cfg.name} ({n_params / 1e9:.2f} B parameters) on "
          f"{mesh_shape(mesh)} over one {backend} rank, laid out by "
          f"param_specs, cache by cache_specs (local {local}); "
          f"{MESH_SERVE_BATCH} x {MESH_SERVE_PROMPT} prefill, "
          f"{MESH_SERVE_DECODE} decodes: rel L2 vs the one-device serve "
          f"prefill {errs['prefill']:.2e}, decode {errs['decode']:.2e} "
          f"(first step {errs['decode_first']:.2e}; with the one-device "
          f"core in place of the merge {errs['decode_core_swapped']:.2e}; "
          f"bound {bound:.4f}); tokens equal "
          f"{report['mesh_serve']['tokens_equal']}; collectives {calls} "
          f"(as reckoned); launches {launches}")
    print(f"mesh serve ms: prefill {run['prefill_ms']:.1f} (one device "
          f"{one['prefill_ms']:.1f}), decode step {run['decode_ms']:.2f} "
          f"(one device {one['decode_ms']:.2f}); peak device memory "
          f"{peak_a / 1e9:.2f} GB; {gpu}")
    print(f"model axis of {MESH_MODEL_AXIS}, rank by rank: "
          + json.dumps(parts))


def mesh_rank_parts(torch, model, cfg, seed: int) -> dict:
    """Phase 26 (b): each rank's part at a model axis of
    ``MESH_MODEL_AXIS``, computed rank by rank on the card and combined as
    the collectives would, against the whole computation; ``model`` is
    the phase's Zamba2 on one device (its first SSD layer's inputs)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models import ssd as SSD
    from repro_torch.models.transformer import _embed
    m = MESH_MODEL_AXIS
    g = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    bf16 = torch.bfloat16
    tol = FLASH_TOL[str(bf16)]
    out = {}
    # the sequence-sharded attention: 256 query rows a rank
    b, s, h, hkv, dh = SEQ_SHARD_SHAPE
    q = torch.randn(b, s, h, dh, generator=g, device=DEVICE).to(bf16)
    k, v = (torch.randn(b, s, hkv, dh, generator=g, device=DEVICE).to(bf16)
            for _ in range(2))
    do = torch.randn(b, s, h, dh, generator=g, device=DEVICE).to(bf16)
    rows = s // m
    outs, dq, dk, dv = [], [], 0, 0
    for r in range(m):
        qr = q[:, r * rows:(r + 1) * rows]
        o, probs = L.seq_rows_forward(qr, k, v, True, r * rows)
        dqr, dkr, dvr = L.seq_rows_backward(qr, k, v, probs,
                                            do[:, r * rows:(r + 1) * rows])
        outs.append(o)
        dq.append(dqr)
        dk, dv = dk + dkr, dv + dvr                      # the all-reduce
        del probs
    got = torch.cat(outs, dim=1)                         # the gather
    flash = ops.flash_attention(q, k, v, causal=True)
    ok_f, err_f = _close_err(got, flash, tol)
    o1, p1 = L.seq_rows_forward(q, k, v, True, 0)
    dq1, dk1, dv1 = L.seq_rows_backward(q, k, v, p1, do)
    del p1
    out["seq_attention"] = {
        "shape": SEQ_SHARD_SHAPE, "ranks": m, "rows": rows,
        "logits_bytes_a_rank": 4 * h * rows * s,
        "vs_flash_max_abs": err_f, "tol": tol, "vs_flash_ok": ok_f,
        "vs_one_slice_max_abs": float((got.float() - o1.float()).abs()
                                      .max()),
        "dq_rel": rel_l2(torch.cat(dq, dim=1), dq1),
        "dk_rel": rel_l2(dk, dk1), "dv_rel": rel_l2(dv, dv1)}
    del q, k, v, do, outs, got, flash, o1, dq, dk, dv, dq1, dk1, dv1
    torch.cuda.empty_cache()
    # Zamba2's first SSD layer at the long prefill's shape, by heads
    layer = model.layers[0]
    toks = torch.randint(0, cfg.vocab, (LONG_BATCH, LONG_SEQ), generator=g,
                         device=DEVICE)
    p, sc = layer.ssd, cfg.ssd
    with torch.inference_mode():
        x = L.rms_norm(layer.ln, _embed(model, toks))
        z, xbc, dt_raw = SSD._split_proj(p, x, sc)
        xbc, _ = SSD._causal_conv(p, xbc, sc)
        nh, di = sc.n_heads, sc.d_inner
        xs = xbc[..., :di].reshape(LONG_BATCH, LONG_SEQ, nh, sc.headdim)
        bm, cm = xbc[..., di:di + sc.d_state], xbc[..., di + sc.d_state:]
        dt = torch.nn.functional.softplus(dt_raw.float() + p.dt_bias).to(
            x.dtype)
        a = -torch.exp(p.A_log)
        y1, h1 = ops.ssd_scan(xs, bm, cm, dt, a, chunk=sc.chunk)
        hh = nh // m
        exact, worst = True, 0.0
        for r in range(m):
            sl = slice(r * hh, (r + 1) * hh)
            yr, hr = ops.ssd_scan(xs[:, :, sl].contiguous(), bm, cm,
                                  dt[..., sl].contiguous(), a[sl],
                                  chunk=sc.chunk)
            exact &= bool(torch.equal(yr, y1[:, :, sl])
                          and torch.equal(hr, h1[:, sl]))
            worst = max(worst, float((yr.float() - y1[:, :, sl].float())
                                     .abs().max()))
        y = (y1 + p.D.to(x.dtype)[None, None, :, None] * xs).reshape(
            LONG_BATCH, LONG_SEQ, di) * torch.nn.functional.silu(z)
        ss1 = L.sum_squares(y)
        ssm = sum(L.sum_squares(y[..., r * (di // m):(r + 1) * (di // m)])
                  for r in range(m))
    out["ssd_heads"] = {"shape": [LONG_BATCH, LONG_SEQ, nh, sc.headdim,
                                  sc.d_state], "ranks": m,
                        "heads_a_rank": hh, "launches": m + 1,
                        "bitexact": exact, "max_abs": worst,
                        "norm_sum_rel": rel_l2(ssm, ss1)}
    del x, z, xbc, dt_raw, xs, bm, cm, dt, y1, h1, y
    torch.cuda.empty_cache()
    # LLaVA's decode attention at a cache of 4096, 16 slices merged
    b, n, h, hkv, dh = DECODE_MERGE_SHAPE
    q = torch.randn(b, 1, h, dh, generator=g, device=DEVICE).to(bf16)
    ck, cv = (torch.randn(b, n, hkv, dh, generator=g, device=DEVICE).to(bf16)
              for _ in range(2))
    pos, part = n - 1, n // m

    def merged(slices):
        size = n // slices
        logits = [L.scores(q, ck[:, r * size:(r + 1) * size], pos,
                                  r * size, True) for r in range(slices)]
        top = torch.stack([lg.amax(-1, keepdim=True) for lg in logits]).amax(0)
        e = [torch.exp(lg - top) for lg in logits]
        total = sum(t.sum(-1, keepdim=True) for t in e)
        return sum(L.decode_values(t / total, cv[:, r * size:(r + 1) * size],
                                   bf16) for r, t in enumerate(e)).to(bf16)

    got, one = merged(m), merged(1)
    ok_d, err_d = _close_err(got, ref.mha_ref(q, ck, cv, True, pos), tol)
    out["decode_merge"] = {"shape": DECODE_MERGE_SHAPE, "ranks": m,
                           "positions_a_rank": part,
                           "vs_one_slice_max_abs": float(
                               (got.float() - one.float()).abs().max()),
                           "vs_materialised_max_abs": err_d, "tol": tol,
                           "vs_materialised_ok": ok_d}
    a_ = out["seq_attention"]
    if not (a_["vs_flash_ok"] and a_["vs_one_slice_max_abs"] <= tol
            and max(a_["dq_rel"], a_["dk_rel"], a_["dv_rel"]) <= PART_RTOL):
        raise AssertionError(f"sequence-sharded attention by rank: {a_}")
    if out["ssd_heads"]["max_abs"] > SSD_TOL[str(bf16)]:
        raise AssertionError(f"SSD heads by rank: {out['ssd_heads']}")
    if out["ssd_heads"]["norm_sum_rel"] > PART_RTOL:
        raise AssertionError(f"the norm's sum of squares by rank: "
                             f"{out['ssd_heads']}")
    d_ = out["decode_merge"]
    if not (ok_d and d_["vs_one_slice_max_abs"] <= tol):
        raise AssertionError(f"decode merge by slice: {d_}")
    return out


DRYRUN_WORKERS = 3
DRYRUN_MESHES = ("host", "single", "multi")
ROOFLINE_CELLS = (("zamba2_2_7b", "prefill", LONG_BATCH, LONG_SEQ),
                  ("olmoe_1b_7b", "prefill", SERVE_REQUESTS, SERVE_PROMPT),
                  ("internlm2_1_8b", "train", TRAIN_BATCH, TRAIN_SEQ))
PEAK_RTOL = 0.10        # the plain run's peak against the count's estimate


def dryrun_cell(argv: list) -> tuple:
    """One ``launch.dryrun.main`` call in a worker process, its own status
    line kept out of the script's output: (its records, the wall clock
    when it ended)."""
    import io
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    with contextlib.redirect_stdout(io.StringIO()):
        return dryrun.main(argv), time.time()


def dryrun_worker_init() -> None:
    """A grid worker runs at the lowest priority on one torch thread, so
    the phases that run meanwhile keep the host."""
    import os
    import torch
    os.nice(19)
    torch.set_num_threads(1)


def start_dryrun_grid() -> tuple:
    """Phase 23 (a) started: ``launch.dryrun.main`` over every
    (architecture, shape, mesh) cell on ``meta`` (the train cells first),
    one call a cell in a pool of ``DRYRUN_WORKERS`` spawned processes (a
    production cell starts and ends its fake group in its worker); returns
    (the pool, the pending results, the wall clock at the start)."""
    import multiprocessing
    import shutil
    from repro_torch import configs
    out = ROOT / "chiprun_out" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((a, s) for a in configs.ARCH_IDS for s in configs.SHAPES),
                   key=lambda c: (order[configs.SHAPES[c[1]]["kind"]]
                                  + (c[1] == "long_500k")))
    argvs = [["--arch", a, "--shape", s, "--mesh", m, "--out", str(out)]
             for a, s in cells for m in DRYRUN_MESHES]
    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN_WORKERS, initializer=dryrun_worker_init)
    return pool, pool.map_async(dryrun_cell, argvs, chunksize=1), time.time()


def phase_dryrun_grid(grid: tuple, report: dict) -> None:
    """Phase 23 (a): the grid's records (under ``chiprun_out/dryrun/``)
    collected from ``start_dryrun_grid``'s pool, which is then closed, and
    ``launch.report.main``'s tables in ``chiprun_out/dryrun_report.md``.
    Fails unless, on each mesh, 32 cells are ok, 8 skipped (``long_500k``
    on the eight full-attention configs) and none is an error."""
    import io
    from repro_torch.launch import report as R
    pool, pending, t0 = grid
    t_wait = time.perf_counter()
    done = pending.get(timeout=600)
    waited = time.perf_counter() - t_wait
    pool.close()
    pool.join()
    records = [r for recs, _ in done for r in recs]
    seconds = max(end for _, end in done) - t0
    out = ROOT / "chiprun_out" / "dryrun"
    with contextlib.redirect_stdout(io.StringIO()):
        text = R.main([str(out)])
    (ROOT / "chiprun_out" / "dryrun_report.md").write_text(text + "\n")
    records.sort(key=lambda r: (r["arch"], r["shape"],
                                DRYRUN_MESHES.index(r["mesh"])))
    status = {k: sum(r["status"] == k for r in records)
              for k in ("ok", "skipped", "error")}
    for r in records:
        if r["status"] != "ok":
            print(f"dryrun {r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
                  f"{r['status']} "
                  f"{r.get('error', r.get('reason', ''))[:100]}")
            continue
        rf, m = r["roofline"], r["memory"]
        print(f"dryrun {r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
              f"{rf['dominant']:10s} compute {rf['compute_s']:.3e} s, "
              f"memory (kernels) {rf['memory_s_flash']:.3e} s, collective "
              f"{rf['collective_s']:.3e} s, peak "
              f"{m['peak_estimate_bytes'] / 1e9:.1f} GB, fits 80 GB "
              f"{m['fits_card']} ({r['trace_s']} s traced)")
    by_mesh = {mesh: {k: sum(r["status"] == k for r in records
                             if r["mesh"] == mesh)
                      for k in ("ok", "skipped", "error")}
               for mesh in DRYRUN_MESHES}
    report["dryrun_grid"] = {
        "seconds": seconds, "waited_s": waited, "workers": DRYRUN_WORKERS,
        "status": status, "by_mesh": by_mesh,
        "cells": {f"{r['arch']}/{r['shape']}/{r['mesh']}": {
            k: r[k] for k in ("status", "chips", "trace_s", "n_ops",
                              "memory", "roofline", "collectives_by_axis",
                              "model_flops", "cast_bytes")
            if k in r} for r in records}}
    print(f"dryrun grid: {len(records)} cells in {seconds:.1f} s on "
          f"{DRYRUN_WORKERS} background processes (phase 23 waited "
          f"{waited:.1f} s for them): {status}; tables in "
          "chiprun_out/dryrun_report.md")
    want = {"ok": 32, "skipped": 8, "error": 0}
    if any(n != want for n in by_mesh.values()):
        raise AssertionError(f"dry-run grid: {by_mesh}, expected on each "
                             "mesh 32 ok, 8 skipped, 0 errors")


def roofline_cell(torch, arch: str, kind: str, batch: int, seq: int,
                  seed: int) -> dict:
    """Phase 23 (b), one cell: the step counted by ``op_count.analyze`` on
    ``meta``, then run on the card with the model kernels and with their
    plain versions (``flash_attention``, and ``ssd_scan`` where the model
    has SSD layers), each run's peak device memory from
    ``reset_peak_memory_stats`` to its end against the count's estimate,
    and the kernel run's time against the roofline bound on the kernel
    path."""
    from repro_torch import configs
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import op_count, roofline
    from repro_torch.models import init_params
    from repro_torch.models.transformer import abstract_params
    from repro_torch.serve.serve_step import make_prefill_step
    from repro_torch.train import AdamW, make_train_step
    cfg = configs.get(arch)

    def inputs(device):
        tokens = (torch.empty((batch, seq), dtype=torch.int32, device="meta")
                  if device == "meta" else torch.randint(
                      0, cfg.vocab, (batch, seq), dtype=torch.int32,
                      generator=torch.Generator(device=device).manual_seed(
                          seed + 7), device=device))
        return ({"tokens": tokens, "labels": tokens.clone()}
                if kind == "train" else {"tokens": tokens})

    def step_and_args(model, device):
        if kind == "train":
            opt = AdamW()
            return make_train_step(cfg, opt), (model, opt.init(model),
                                               inputs(device))
        return make_prefill_step(cfg, device=device), (model, inputs(device))

    t0 = time.perf_counter()
    abstract = abstract_params(cfg).requires_grad_(kind == "train")
    step, args = step_and_args(abstract, "meta")
    cost = op_count.analyze(step, *args)
    del abstract, args
    roof = roofline.roofline_from_cost(
        cost, 1, roofline.flash_attention_io_bytes(cfg, seq, batch, kind, 1))
    count_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE, trainable=kind == "train")
    step, args = step_and_args(model, DEVICE)

    def run():
        out = step(*args)
        torch.cuda.synchronize()
        return out

    def plain_scan(xs, bmat, cmat, dt, a, chunk=256):
        ss.check_operands(xs, bmat, cmat, dt, a, chunk)
        return ss.ssd_scan_plain(xs, bmat, cmat, dt, a, chunk)

    def peak_of(ctx) -> int:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            out = run()
        del out
        raw.append(torch.cuda.max_memory_allocated())
        return raw[-1] - base

    raw: list = []

    ms = cuda_ms(torch, run, 2)               # after one warm-up run
    kernel_peak = peak_of(contextlib.nullcontext())
    plain = contextlib.ExitStack()
    plain.enter_context(plain_flash(torch))
    if cfg.ssd is not None:
        plain.enter_context(swap_plain(ss, "ssd_scan", plain_scan))
    plain_peak = peak_of(plain)
    del model, args, step
    gc.collect()
    torch.cuda.empty_cache()
    est = cost.peak_estimate_bytes
    out = {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
           "count_s": count_s, "n_ops": cost.n_ops, "flops": cost.flops,
           "flops_by_dtype": cost.flops_by_dtype, "bytes": cost.bytes,
           "attn_bytes": cost.attn_bytes, "cast_bytes": cost.cast_bytes,
           "flash_io_bytes": roof.flash_io_bytes,
           "compute_ms": 1e3 * roof.compute_s,
           "memory_ms": 1e3 * roof.memory_s,
           "memory_flash_ms": 1e3 * roof.memory_s_flash,
           "bound_ms": 1e3 * roof.bound_s, "dominant": roof.dominant,
           "ms": ms, "ms_over_bound": ms / (1e3 * roof.bound_s),
           "argument_bytes": cost.argument_bytes,
           "peak_estimate_bytes": est, "kernel_peak_bytes": kernel_peak,
           "plain_peak_bytes": plain_peak,
           "plain_peak_rel": (plain_peak - est) / est,
           "allocated_before_bytes": base,
           "max_memory_allocated_bytes": {"kernels": raw[0],
                                          "plain": raw[1]}}
    print(f"roofline {cfg.name} {kind} B {batch} x S {seq}: counted in "
          f"{count_s:.1f} s ({cost.n_ops:,} ops, {cost.flops:.3e} FLOPs "
          f"{ {k: f'{v:.3e}' for k, v in cost.flops_by_dtype.items()} }, "
          f"{cost.bytes:.3e} B, casts {cost.cast_bytes:.3e} B); bound on the "
          f"kernel path {out['bound_ms']:.3f} ms ({roof.dominant}: compute "
          f"{out['compute_ms']:.3f}, memory {out['memory_flash_ms']:.3f} ms, "
          f"materialised {out['memory_ms']:.3f}); measured {ms:.3f} ms "
          f"({out['ms_over_bound']:.2f}x the bound)")
    print(f"  peak memory: estimate {est / 1e9:.3f} GB (arguments "
          f"{cost.argument_bytes / 1e9:.3f}); measured plain "
          f"{plain_peak / 1e9:.3f} GB ({100 * out['plain_peak_rel']:+.2f}%), "
          f"kernels {kernel_peak / 1e9:.3f} GB (max_memory_allocated "
          f"{raw[1] / 1e9:.3f} and {raw[0] / 1e9:.3f} GB, "
          f"{base / 1e9:.3f} GB allocated before the model)")
    if abs(out["plain_peak_rel"]) > PEAK_RTOL:
        raise AssertionError(f"{cfg.name} {kind}: the plain run's peak "
                             f"{plain_peak} is not within {PEAK_RTOL:.0%} of "
                             f"the count's estimate {est}")
    return out


def phase_roofline_cells(torch, seed: int, report: dict) -> None:
    """Phase 23 (b): the three cells of ``ROOFLINE_CELLS``, then flash at
    InternLM2-1.8B's training shape (B 8, S 256, 16 / 8 heads of 128, bf16,
    causal) against its bound and ``scaled_dot_product_attention``."""
    cells = {f"{a}/{k}": roofline_cell(torch, a, k, b, s, seed)
             for a, k, b, s in ROOFLINE_CELLS}
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    q, k, v = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, h, 128), generator=gen,
                           device=DEVICE, dtype=torch.bfloat16)
               for h in (16, 8, 8))
    train_flash = flash_timing(torch, q, k, v, True)
    bound_and_print(torch, "flash_attention at internlm2's training shape",
                    train_flash)
    del q, k, v
    report["roofline_cells"] = cells
    report["train_shape_flash"] = train_flash


RANK_STEP_CELLS = (("zamba2_2_7b", "train_4k"), ("zamba2_2_7b", "prefill_32k"),
                   ("zamba2_2_7b", "decode_32k"))
RANK_STEP_MESH = "single"         # rank 0 of (data 16, model 16)
RANK_PEAK_LIMIT = 72e9            # the counted peak a cell may have
RANK_STEP_STEPS = 2               # timed steps, after one untimed
# phase 27's runs, each (candidate cells, timed steps): Zamba2's rank
# drives flash and ``ssd_scan``; LLaVA-NeXT-34B's, whose 8 kv heads do not
# divide the model axis of 16, drives the attention weights gathered at
# use (``models.layers.at_use``) and no hand-written kernel
RANK_STEP_RUNS = {"kernels": (RANK_STEP_CELLS, RANK_STEP_STEPS),
                  "gathered": ((("llava_next_34b", "train_4k"),), 1)}


def seeded_shards(torch, device: str, seed: int, rank: int = 0):
    """``launch.dryrun.rank_model``'s ``make``: a leaf's shard on
    ``device`` from a generator seeded by the leaf's name and the rank,
    normal · 0.02 (no whole leaf is made)."""
    import zlib

    def make(name: str, shape: tuple, dtype):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + zlib.crc32(f"{name}@{rank}".encode()))
        return (0.02 * torch.randn(shape, generator=gen, device=device)
                ).to(dtype)
    return make


def seeded_batch(torch, cfg, shape: str, seed: int) -> dict:
    """The cell's global batch on ``DEVICE`` (``configs.input_specs``'
    shapes): seeded tokens and labels, seeded bf16 frontend embeddings;
    a decode's cache is the step's own (``launch.dryrun.cell_step``)."""
    from repro_torch import configs
    specs, _ = configs.input_specs(cfg, shape)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    out = {}
    for name, t in specs.items():
        if name == "cache":
            continue
        out[name] = (torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                   dtype=t.dtype, device=DEVICE)
                     if t.dtype == torch.int32 else
                     torch.randn(t.shape, generator=gen, device=DEVICE
                                 ).to(t.dtype))
    return out


def capture_first_calls(torch, seen: dict):
    """Stand-ins for the two model kernels' counted launches that keep the
    first call's operand shapes and dtypes (and flash's ``causal``, the
    SSD's chunk) and launch as the real ones do; returns a function that
    puts the real ones back."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    real_fa, real_ss = fa._launch, ss._launch

    def spec(*ts):
        return [(tuple(t.shape), str(t.dtype)) for t in ts]

    def flash(q, k, v, causal, lse=None):
        seen.setdefault("flash_attention", {"operands": spec(q, k, v),
                                            "causal": bool(causal)})
        return real_fa(q, k, v, causal, lse)

    def ssd(xs, bmat, cmat, dt, a, chunk):
        seen.setdefault("ssd_scan", {"operands": spec(xs, bmat, cmat, dt, a),
                                     "chunk": int(chunk)})
        return real_ss(xs, bmat, cmat, dt, a, chunk)

    fa._launch, ss._launch = flash, ssd

    def restore():
        fa._launch, ss._launch = real_fa, real_ss
    return restore


def first_call_checks(torch, seen: dict, seed: int) -> dict:
    """Each model kernel once at its first call's shapes on seeded inputs
    against its plain version (``FLASH_TOL``, ``SSD_TOL``, as phases 10
    and 26 hold them)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 23)
    dtypes = {"torch.float32": torch.float32,
              "torch.bfloat16": torch.bfloat16}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE)
                ).to(dtype)

    out = {}
    if "flash_attention" in seen:
        f = seen["flash_attention"]
        (qs, dt), (ks, _), (vs, _) = f["operands"]
        q, k, v = (randn(sh, dtypes[dt]) for sh in (qs, ks, vs))
        got = fa.flash_attention(q, k, v, f["causal"])
        want = fa.flash_attention_plain(q, k, v, f["causal"])
        ok, err = _close_err(got, want, FLASH_TOL[dt])
        out["flash_attention"] = {"shape": [qs, ks], "dtype": dt,
                                  "causal": f["causal"], "ok": ok,
                                  "max_abs_err": err,
                                  "instance": fa.instance(q, k, v)}
        del q, k, v, got, want
    if "ssd_scan" in seen:
        f = seen["ssd_scan"]
        (xs_s, dt_x), (b_s, dt_b), _, (d_s, dt_d), (a_s, _) = f["operands"]
        xs = randn(xs_s, dtypes[dt_x])
        bm, cm = randn(b_s, dtypes[dt_b], 0.3), randn(b_s, dtypes[dt_b], 0.3)
        dt = torch.nn.functional.softplus(randn(d_s, torch.float32)).to(
            dtypes[dt_d])
        a = -torch.exp(randn(a_s, torch.float32, 0.2))
        y, st = ss.ssd_scan(xs, bm, cm, dt, a, f["chunk"])
        y_want, st_want = ss.ssd_scan_plain(xs, bm, cm, dt, a, f["chunk"])
        tol = SSD_TOL[dt_x]
        (ok_y, err_y), (ok_s, err_s) = (_close_err(y, y_want, tol),
                                        _close_err(st, st_want, tol))
        out["ssd_scan"] = {"shape": xs_s, "chunk": f["chunk"], "dtype": dt_x,
                           "ok": ok_y and ok_s, "max_abs_err": err_y,
                           "state_max_abs_err": err_s}
    torch.cuda.synchronize()
    return out


def rank_step_child(out_path: str, seed: int, run: str = "kernels") -> None:
    """Phase 27's subprocess: count the candidate cells of
    ``RANK_STEP_RUNS[run]`` on ``meta`` until one's peak is under
    ``RANK_PEAK_LIMIT``, then run that cell's rank-0 step on the card
    under a fake group of the production mesh's ranks (one untimed step,
    then the run's timed steps), and write what it measured to
    ``out_path`` (JSON): the model group's collectives of the timed steps
    by ``sharding.TP_CALLS`` kind among it."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import counting_group
    from repro_torch.sharding import TP_CALLS, make_ctx, zero_tp_calls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells, steps = RANK_STEP_RUNS[run]
    tried = []
    for arch, shape in cells:
        cfg = configs.get(arch)
        t0 = time.perf_counter()
        cost, chips, _ = dryrun.count_cell(cfg, shape, RANK_STEP_MESH)
        tried.append({"arch": arch, "shape": shape,
                      "peak_estimate_bytes": cost.peak_estimate_bytes,
                      "count_s": time.perf_counter() - t0})
        if cost.peak_estimate_bytes <= RANK_PEAK_LIMIT:
            break
    else:
        raise AssertionError(f"no cell of {cells} has a rank peak under "
                             f"{RANK_PEAK_LIMIT / 1e9} GB: {tried}")
    info = configs.SHAPES[shape]
    roof = roofline.roofline_from_cost(
        cost, chips, roofline.flash_attention_io_bytes(
            cfg, info["seq"], info["batch"], info["kind"], chips))
    bound_s = max(roof.compute_s, roof.memory_s_flash)
    seen: dict = {}
    with counting_group(RANK_STEP_MESH, DEVICE) as mesh:
        ctx = make_ctx(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = dryrun.rank_model(cfg, mesh, make=seeded_shards(
            torch, DEVICE, seed))
        kind, step, args = dryrun.cell_step(
            cfg, shape, model, ctx, device=DEVICE,
            batch=seeded_batch(torch, cfg, shape, seed))
        restore = capture_first_calls(torch, seen)
        try:
            step(*args)                     # untimed: the allocator warms
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.LAUNCHES = ss.LAUNCHES = 0
            zero_tp_calls()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                step(*args)
            end.record()
            end.synchronize()
            launches = {"flash_attention": fa.LAUNCHES,
                        "ssd_scan": ss.LAUNCHES}
            tp_calls = {k: v for k, v in TP_CALLS.items() if v}
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            restore()
        ms = start.elapsed_time(end) / steps
        del model, step, args
    gc.collect()
    torch.cuda.empty_cache()
    checks = first_call_checks(torch, seen, seed)
    est = cost.peak_estimate_bytes
    out = {"run": run, "arch": arch, "shape": shape, "mesh": RANK_STEP_MESH,
           "chips": chips, "kind": kind, "tried": tried,
           "steps": steps, "ms_per_step": ms, "tp_calls": tp_calls,
           "bound_ms": 1e3 * bound_s, "ms_over_bound": ms / (1e3 * bound_s),
           "compute_ms": 1e3 * roof.compute_s,
           "memory_flash_ms": 1e3 * roof.memory_s_flash,
           "collective_ms": 1e3 * roof.collective_s,
           "flops": cost.flops, "bytes": cost.bytes, "n_ops": cost.n_ops,
           "collective_bytes": roof.coll.total_bytes,
           "peak_estimate_bytes": est, "argument_bytes": cost.argument_bytes,
           "peak_bytes": peak, "peak_rel": (peak - est) / est,
           "allocated_before_bytes": base, "launches": launches,
           "first_calls": seen, "checks": checks}
    Path(out_path).write_text(json.dumps(out))


def rank_step_run(torch, seed: int, gpu: str, run: str) -> dict:
    """``rank_step_child`` of ``run`` in a subprocess; its lines printed and
    its record returned (``chiprun_out/rank_step[_<run>].json``)."""
    gc.collect()
    torch.cuda.empty_cache()
    name = "rank_step.json" if run == "kernels" else f"rank_step_{run}.json"
    out = ROOT / "chiprun_out" / name
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
         f"chip_smoke.rank_step_child({str(out)!r}, {seed}, {run!r})"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 27's {run} rank step failed (rc "
                             f"{proc.returncode}): {proc.stderr[-3000:]}")
    r = json.loads(out.read_text())
    r["wall_s"] = wall
    print(f"production rank ({gpu}): {r['arch']} {r['shape']} rank 0 of "
          f"{r['chips']} ({r['mesh']}), {r['steps']} steps after one "
          f"untimed: {r['ms_per_step']:.1f} ms a step against the count's "
          f"bound {r['bound_ms']:.1f} ms (compute {r['compute_ms']:.1f}, "
          f"memory on the kernel path {r['memory_flash_ms']:.1f}; "
          f"collectives free: the fake group moves none of the count's "
          f"{r['collective_bytes'] / 1e9:.2f} GB, {r['collective_ms']:.1f} "
          f"ms at one link, and leaves gathers unwritten, so only memory "
          f"and time are measured, not values), "
          f"{r['ms_over_bound']:.2f}x the bound; {r['n_ops']:,} ops counted "
          f"a step, {1e3 * r['ms_per_step'] / r['n_ops']:.2f} us an op")
    print(f"  peak {r['peak_bytes'] / 1e9:.3f} GB against the estimate "
          f"{r['peak_estimate_bytes'] / 1e9:.3f} GB "
          f"({100 * r['peak_rel']:+.2f}%; arguments "
          f"{r['argument_bytes'] / 1e9:.3f} GB); launches {r['launches']}; "
          f"model-group collectives of the timed steps {r['tp_calls']}; "
          f"cells counted {[(t['arch'], t['shape'], round(t['peak_estimate_bytes'] / 1e9, 2)) for t in r['tried']]}; "
          f"{wall:.1f} s in all")
    for name, c in r["checks"].items():
        print(f"  {name} at its first call's shape {c['shape']} "
              f"({c['dtype']}): max abs err {c['max_abs_err']:.3e} against "
              f"the plain version, ok {c['ok']}")
    if abs(r["peak_rel"]) > PEAK_RTOL:
        raise AssertionError(f"phase 27 ({run}): the peak {r['peak_bytes']} "
                             f"is not within {PEAK_RTOL:.0%} of the count's "
                             f"estimate {r['peak_estimate_bytes']}")
    return r


def phase_rank_step(torch, seed: int, gpu: str, report: dict) -> None:
    """Phase 27: ``RANK_STEP_RUNS``' two production ranks, each through
    ``rank_step_run``; the first's launches kept for the kernels line.
    Fails if a step raised, a kernel disagreed with its plain version, a
    peak is off the count's estimate by more than ``PEAK_RTOL``, the
    Zamba2 rank launched no flash or ``ssd_scan``, or the LLaVA rank
    gathered no attention weight at use."""
    r = rank_step_run(torch, seed, gpu, "kernels")
    report["rank_step"] = r
    bad = [n for n, c in r["checks"].items() if not c["ok"]]
    if bad or set(r["checks"]) != {"flash_attention", "ssd_scan"}:
        raise AssertionError(f"phase 27: kernel checks {r['checks']}")
    if any(n <= 0 for n in r["launches"].values()):
        raise AssertionError(f"phase 27: launches {r['launches']}")
    g = rank_step_run(torch, seed, gpu, "gathered")
    report["rank_step_gathered"] = g
    if g["tp_calls"].get("gather_weight", 0) <= 0:
        raise AssertionError(f"phase 27: the {g['arch']} rank gathered no "
                             f"attention weight: {g['tp_calls']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waves", type=int, default=16)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 8 fresh served waves, then the same 8 "
                    "served again (memoized plans), with torch.profiler")
    ap.add_argument("--min-waves", type=int, default=TRIGGER["min_waves"],
                    help="the write phase trigger's streak length; the "
                    "phase checks that exactly one migration fires")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's sources are missing ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2
    # the plain versions and the model's float32 products compare in full
    # float32 (TF32 keeps about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"seed": args.seed, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "allow_tf32": False}
    t_all = time.perf_counter()
    gpu = gpu_line(torch)
    report["gpu"] = gpu
    phase_build(report)
    grid = start_dryrun_grid()          # phase 23 (a), in the background
    try:
        phase_small(torch, np, report)
        phase_segments(torch, np, report)
        phase_gather_bitmap_small(torch, np, report)
        phase_model_small(torch, report)
        store, w, tree = make_store(np, args.seed, report)
        waves = wave_traffic(np, args.seed, args.waves,
                             store.graph.n_versions)
        phase_main(torch, np, store, waves, report)
        mean = phase_timing(torch, np, store, waves, report)
        if args.profile:
            fresh = wave_traffic(np, args.seed + 1, 8, store.graph.n_versions)
            phase_profile(torch, store, fresh, report, "fresh")
            phase_profile(torch, store, fresh, report, "repeat")
        ds_vids = phase_dataset(torch, np, store, args.seed, report)
        inputs = phase_analytics(torch, np, store, args.seed, report)
        timed = phase_dataset_analytics_timing(torch, np, store, ds_vids,
                                               inputs, report)
        del store, inputs           # the read path's store and superblock go
        gc.collect()
        torch.cuda.empty_cache()
        captured = phase_write(torch, np, w, tree, args.seed,
                               dict(TRIGGER, min_waves=args.min_waves),
                               report)
        seg = phase_write_timing(torch, np, captured, report)
        del captured
        phase_durable(torch, np, w, tree, args.seed, gpu, report)
        del w, tree
        gc.collect()
        torch.cuda.empty_cache()
        model = phase_serve(torch, args.seed, report)
        model_inputs = phase_long_prefill(torch, model, args.seed, report)
        phase_model_profile(torch, model, args.seed, report)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model_t = phase_model_timing(torch, model_inputs, report)
        family_inputs = phase_families(torch, args.seed, report)
        phase_family_flash_timing(torch, family_inputs, report)
        gc.collect()
        torch.cuda.empty_cache()
        encdec_inputs = phase_encdec_serve(torch, args.seed, report)
        vlm_inputs = phase_vlm_serve(torch, args.seed, report)
        phase_new_family_flash_timing(torch, encdec_inputs, vlm_inputs,
                                      report)
        del encdec_inputs, vlm_inputs
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_dense(torch, np, args.seed, report)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_ssm(torch, np, args.seed, report)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_compressed(torch, np, args.seed, gpu, report)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_tp(torch, np, args.seed, gpu, report)
        gc.collect()
        torch.cuda.empty_cache()
        phase_mesh_serve(torch, args.seed, gpu, report)
        gc.collect()
        torch.cuda.empty_cache()
        phase_rank_step(torch, args.seed, gpu, report)
        phase_roofline_cells(torch, args.seed, report)
        phase_dryrun_grid(grid, report)
    finally:
        grid[0].terminate()             # stops its workers, done or not
    report["total_s"] = time.perf_counter() - t_all
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    rows = {"checkout_wave": dict(
        launches=report["main"]["launches"],
        max_abs_err=max(w["max_abs_err"] for w in report["per_wave"]),
        ms=mean["ms"], plain_ms=mean["plain_ms"], bound_ms=mean["bound_ms"],
        bound_by="bytes", library_ms=mean["library_ms"])}
    for name in ("segment_append", "segment_move"):
        rows[name] = dict(
            launches=report["write"]["launches"][name],
            **{k: seg[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")},
            bound_by="bytes")
    train = [report[k]["launches"] for k in ("train_dense", "train_ssm",
                                             "train_compressed", "train_tp")]
    for name, path in (("gather_row_tiles", "dataset"),
                       ("gather_rows", "dataset"),
                       ("membership_scan", "analytics"),
                       ("version_aggregate", "analytics")):
        rows[name] = dict(
            launches=report[path]["launches"][name]
            + sum(t.get(name, 0) for t in train),
            **{k: timed[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "library_ms")},
            bound_by=timed[name].get("bound_by", "bytes"))
    model_paths = [report[k]["launches"]["prefill"]
                   for k in ("serve", "moe_serve", "mla_serve", "vlm_serve")]
    model_paths += [r["launches"]["prefill"]
                    for r in report["dense_serve"].values()]
    model_paths.append(report["encdec_serve"]["launches"]["window"])
    model_paths.append(report["mesh_serve"]["launches"])
    model_paths.append(report["rank_step"]["launches"])
    model_paths.append(report["rank_step_gathered"]["launches"])
    for name in ("flash_attention", "ssd_scan"):
        rows[name] = dict(
            launches=sum(r[name] for r in model_paths)
            + sum(t[name] for t in train),
            **{k: model_t[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")})
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{lib}.cu", "replaces": replaces,
         **{k: rows[name][k] for k in ("launches", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}}
        for name, (lib, replaces) in KERNELS.items()]}
    bwd = report["train_dense"]["flash_backward"]["cell"]
    kernels["kernels"].append({
        "name": "flash_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_backward.cu",
        "replaces": "none: the reference's backward is jnp "
                    "(src/repro/kernels/ops.py _flash_bwd_rule)",
        "launches": sum(t.get("flash_backward", 0) for t in train),
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["backward_kernel_ms"],
        "plain_ms": bwd["backward_plain_ms"],
        "bound_ms": bwd["backward_bound_ms"],
        "bound_by": bwd["backward_bound_by"],
        "library_ms": bwd["library_bwd_ms"]})
    if any(k["launches"] <= 0 for k in kernels["kernels"]):
        raise AssertionError(f"a kernel was not launched on its path: "
                             f"{kernels}")
    print(f"total {report['total_s']:.1f} s")
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
