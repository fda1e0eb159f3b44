"""Multi-rank harness for the port's mesh tests on the CPU.

``spawn(fn, world, tmp, *args)`` starts ``world`` processes (the ``spawn``
start method), each joining a gloo group through a ``file://`` store
under ``tmp`` (no TCP port, so test files can run side by side), runs
``fn(rank, world, *args)`` and leaves the group.  Every wait has its own
limit: the group's collectives time out after ``GROUP_TIMEOUT_S``, and
``spawn`` joins for ``JOIN_TIMEOUT_S`` and then kills what is left and
fails, so a hung rank fails its test, not the suite.

The rank functions here import no jax: each case loads the reference's
weights and batches from an ``.npz`` the test wrote, and rank 0 writes
what the test compares.  ``reference_main`` is the reference side, run by
a test in one subprocess with four faked host devices.

The model axis's cases (``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_expert_parallel.py``): a plain case's ``mesh`` (data,
model) puts ranks on "model"; ``collectives`` holds the differentiable
collectives and a SwiGLU and MoE block at tp m against the one-device
computation; ``exchange`` runs the port's ``_dispatch_combine`` on a
model axis; ``refusals`` records whether a step runs or raises
``PlanError``; ``tp_restore`` restores and saves checkpoints across
(data, model) meshes; ``tp_calls`` counts the model group's collectives
a step; ``remat_thread`` differentiates a remat'd block on another thread.
The reference's "exchange" case runs its ``_dispatch_combine`` in
``shard_map`` over "model".

The model axis's second half (``tests/test_torch_seq_parallel.py``,
``tests/test_torch_ssd_parallel.py``, ``tests/test_torch_mesh_serve.py``):
``seq_attention`` holds the sequence-sharded attention and the decode
merge at tp m against the whole computation, ``ssd_layer`` an SSD layer's
heads split over "model" against the one-device layer, ``serve`` the
prefill and decode steps on a (data, model) mesh; the reference's
"serve" kind serves the same on its mesh.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np

GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 240


def _rank_main(fn, rank, world, store, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)        # several ranks share the host's cores
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args, timeout: float = JOIN_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; raise if a
    rank fails or the ranks outlast ``timeout`` seconds."""
    import multiprocessing as mp
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(str(tmp), f"store-{fn.__name__}-{world}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"{fn.__name__}: ranks {hung} of {world} still "
                           f"running after {timeout} s")
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if bad:
        raise RuntimeError(f"{fn.__name__}: ranks exited {bad}")


# ------------------------------------------------------------ configs ----
def tiny():
    """The ``ArchConfig`` of ``tests/test_elastic_restart.py``, the port's."""
    from repro_torch.models.transformer import ArchConfig
    return ArchConfig(name="tiny-ft", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv=2, d_ff=128, vocab=256, head_dim=16,
                      tie_embeddings=True, remat=False, microbatches=1)


def port_cfg(name: str, microbatches: int = 1):
    from repro_torch import configs
    cfg = tiny() if name == "tiny" else configs.smoke(name)
    return dataclasses.replace(cfg, microbatches=microbatches)


def nest(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def load_inputs(path):
    """(weights, batches) from the test's ``.npz``: ``w/<path>`` leaves and
    ``tokens<i>``/``labels<i>`` batches (with ``patch_embeds<i>`` where the
    file has them)."""
    z = np.load(path)
    weights = nest({k[2:]: z[k] for k in z.files if k.startswith("w/")})
    batches = []
    for i in range(sum(k.startswith("tokens") for k in z.files)):
        b = {"tokens": z[f"tokens{i}"], "labels": z[f"labels{i}"]}
        if f"patch_embeds{i}" in z.files:
            b["patch_embeds"] = z[f"patch_embeds{i}"]
        batches.append(b)
    return weights, batches


class _f32:
    """The port's compute dtype float32 inside the block."""
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch
        from repro_torch.models import layers as TL
        self.kept = TL.COMPUTE_DTYPE
        if self.on:
            TL.COMPUTE_DTYPE = torch.float32

    def __exit__(self, *exc):
        from repro_torch.models import layers as TL
        TL.COMPUTE_DTYPE = self.kept


def _gathered(model) -> dict:
    """The reference tree of ``model``'s whole parameters (a collective)."""
    from repro_torch.models import to_reference
    from repro_torch.sharding import whole
    return to_reference(model, {n: whole(p).detach()
                                for n, p in model.named_parameters()})


# ---------------------------------------------------------- rank cases ----
def _plain_case(rank, world, spec, out):
    """One data-parallel run: the mesh (world, 1) over ("data", "model"),
    FSDP parameters, ``spec["steps"]`` plain steps on the input's batches,
    then the eval step on the first batch.  Rank 0 writes the losses, grad
    norms, the eval loss and the whole parameters, and every rank its
    shards' sizes against the leaves'."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_reference
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, local, make_ctx
    from repro_torch.train import AdamW, make_eval_step, make_train_step
    cfg = port_cfg(spec["arch"], spec.get("microbatches", 1))
    weights, batches = load_inputs(spec["inputs"])
    mesh = make_mesh(tuple(spec.get("mesh", (world, 1))), ("data", "model"),
                     "cpu")
    ctx = make_ctx(mesh)
    with _f32(spec["f32"]):
        model = from_reference(cfg, weights, device="cpu").requires_grad_(True)
        distribute(model, param_specs(cfg), mesh)
        opt = AdamW(lr=spec["lr"])
        state = opt.init(model)
        step = make_train_step(cfg, opt, ctx=ctx)
        losses, norms = [], []
        for b in batches[:spec["steps"]]:
            model, state, m = step(model, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        evaluated = float(make_eval_step(cfg, ctx)(model, batches[0]))
    shards = {n: [int(local(p).numel()), int(p.numel())]
              for n, p in model.named_parameters()}
    moments = {n: [int(local(t).numel()), int(t.numel())]
               for n, t in state.m.items()}
    params = flat(_gathered(model))
    if rank == 0:
        np.savez(out + ".npz", loss=np.asarray(losses),
                 gnorm=np.asarray(norms), eval=np.asarray([evaluated]),
                 **{"p/" + k: v for k, v in params.items()})
    with open(f"{out}.shards{rank}.json", "w") as f:
        json.dump({"params": shards, "m": moments,
                   "specs": {n: list(map(_jsonable, s)) for n, s in
                             param_specs(cfg).items()}}, f)


def _jsonable(e):
    return list(e) if isinstance(e, tuple) else e


def _compressed_case(rank, world, spec, out):
    """One compressed step on the mesh ``spec["shape"]`` over ("pod",
    "data", "model") from zero residuals (in float32 unless ``spec["f32"]``
    is false): rank 0 writes the loss, the grad
    norm, the whole parameters, the whole residuals and the gradient AdamW
    was given (``ĝ``, gathered)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_reference, to_reference
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, local, make_ctx, whole
    from repro_torch.train import AdamW, ef_init, make_train_step
    cfg = port_cfg(spec["arch"])
    weights, batches = load_inputs(spec["inputs"])
    mesh = make_mesh(tuple(spec["shape"]), ("pod", "data", "model"), "cpu")
    ctx = make_ctx(mesh)
    seen = {}

    class Recording(AdamW):
        def update(self, grads, state, params, gnorm=None):
            seen.update({n: g.clone() for n, g in grads.items()})
            return super().update(grads, state, params, gnorm=gnorm)

    with _f32(spec.get("f32", True)):
        model = from_reference(cfg, weights, device="cpu").requires_grad_(True)
        distribute(model, param_specs(cfg), mesh)
        opt = Recording(lr=spec["lr"])
        state = opt.init(model)
        ef = ef_init(model, ctx.size("pod"), ctx)
        step = make_train_step(cfg, opt, grad_compress=True, ctx=ctx)
        model, state, ef, m = step(model, state, ef, batches[0])
    named = dict(model.named_parameters())
    ghat = {n: whole(DTensor.from_local(seen[n], mesh, p.placements,
                                        shape=p.shape, stride=p.stride()))
            for n, p in named.items()}
    ef_whole = {n: whole(e) for n, e in ef.items()}
    shards = {n: [int(local(e).numel()), int(e.numel())]
              for n, e in ef.items()}
    params = flat(_gathered(model))
    ghat = flat(to_reference(model, ghat))
    res = {}
    for i in range(ctx.size("pod")):
        res.update({f"e{i}/" + k: v for k, v in flat(to_reference(
            model, {n: e[i] for n, e in ef_whole.items()})).items()})
    if rank == 0:
        np.savez(out + ".npz", loss=np.asarray([float(m["loss"])]),
                 gnorm=np.asarray([float(m["grad_norm"])]),
                 **{"p/" + k: v for k, v in params.items()},
                 **{"g/" + k: v for k, v in ghat.items()},
                 **{k: v for k, v in res.items()})
    with open(f"{out}.shards{rank}.json", "w") as f:
        json.dump({"ef": shards}, f)


def elastic_case(rank, world, spec):
    """Checkpoints across mesh shapes on two ranks.  ``spec["one_rank"]``
    holds a one-rank save (vid 0) of the port's TINY model in the trainer's
    layout (``to_reference``).  It is restored onto (data, model) = (2, 1)
    and (1, 2) and compared leaf for leaf with its host restore; the (2, 1)
    restore is saved again from both ranks into ``spec["two_rank"]``;
    a state of parameters and per-pod residuals laid out on (pod, data,
    model) = (2, 1, 1) is saved into ``spec["pods"]`` and restored onto one
    pod, (1, 2, 1).  Rank 0 writes what it saw to ``spec["out"]``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import reference_like
    from repro_torch.models.convert import reference_specs
    from repro_torch.models.transformer import abstract_params, param_specs
    from repro_torch.sharding import distribute, local, whole
    from repro_torch.train import CheckpointStore, ef_specs, elastic_reshard
    cfg = tiny()
    like = reference_like(abstract_params(cfg))
    specs = reference_specs(param_specs(cfg))
    store = CheckpointStore(spec["one_rank"], shard_rows=1 << 10)
    want = flat(store.restore(0, treedef_like=like))
    seen = {"bitexact": {}, "shares": {}}
    meshes = {"2x1": make_mesh((2, 1), ("data", "model"), "cpu"),
              "1x2": make_mesh((1, 2), ("data", "model"), "cpu")}
    restored = {}
    for key, mesh in meshes.items():
        tree = elastic_reshard(store, 0, mesh, specs, treedef_like=like)
        restored[key] = tree
        got = flat(tree)
        seen["bitexact"][key] = all(
            np.array_equal(whole(got[k]).numpy(), want[k]) for k in want)
        seen["shares"][key] = {k: [int(local(v).numel()), int(v.numel())]
                               for k, v in got.items()}
    # a save from two ranks of the (2, 1) layout
    CheckpointStore(spec["two_rank"], shard_rows=1 << 10).save(
        step=1, tree=restored["2x1"], meta={"cursor": 1})
    # two pods' state, then onto one pod
    pods = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    rng = np.random.default_rng(5)
    ef_full = {k: rng.standard_normal((2, *v.shape)).astype(np.float32)
               for k, v in want.items()}
    state = {"params": distribute(nest(want), specs, pods),
             "ef": distribute(nest(ef_full), ef_specs(specs), pods)}
    seen["ef_rows"] = {k: int(local(v).shape[0])
                       for k, v in flat(state["ef"]).items()}
    pstore = CheckpointStore(spec["pods"], shard_rows=1 << 10)
    vid = pstore.save(step=2, tree=state, meta={"cursor": 2})
    one_pod = make_mesh((1, 2, 1), ("pod", "data", "model"), "cpu")
    back = flat(elastic_reshard(pstore, vid, one_pod,
                                {"params": specs, "ef": ef_specs(specs)},
                                treedef_like=state))
    full = {**{"params/" + k: v for k, v in want.items()},
            **{"ef/" + k: v for k, v in ef_full.items()}}
    seen["pods_bitexact"] = all(np.array_equal(whole(back[k]).numpy(), v)
                                for k, v in full.items())
    seen["pods_vid"] = vid
    if rank == 0:
        np.savez(spec["out"] + ".npz", **full)
        with open(spec["out"] + ".json", "w") as f:
            json.dump(seen, f)


def _launcher_case(rank, world, spec, out):
    """``launch.train`` on this group (``WORLD_SIZE`` set as ``torchrun``
    sets it; the group is running, so the driver starts none): a run
    preempted after ``spec["preempt"]`` steps with a checkpoint, then its
    resume.  Rank 0 writes the two runs' JSON lines."""
    import contextlib
    import io
    from repro_torch.launch import train as T
    os.environ["WORLD_SIZE"] = str(world)
    lines = []
    for extra in (["--preempt-after", str(spec["preempt"])], []):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            T.main(spec["argv"] + extra)
        lines.append(buf.getvalue().strip().splitlines())
    if rank == 0:
        with open(out + ".json", "w") as f:
            json.dump([json.loads(run[-1]) for run in lines], f)
    else:
        assert lines == [[], []], lines       # rank 0 alone prints


def _rel_err(got, want) -> float:
    import torch
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _tp_ctx(world):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import make_ctx, tp_group
    ctx = make_ctx(make_mesh((1, world), ("data", "model"), "cpu"))
    return ctx, tp_group(ctx)


def _collectives_case(rank, world, spec, out):
    """Float32, on (data, model) = (1, world), against the one-device
    computation of the same seeded inputs (every rank draws them all):
    ``dense(gather="col")`` then ``dense(gather="row")`` (forward, the
    input's and both weights' gradients; the weights are this rank's
    shards); ``split_seq`` then ``gather_seq`` (the input's gradient
    through a position-weighted loss); a SwiGLU block; and an MoE block
    (OLMoE's SMOKE geometry with shared experts) in the token-parallel
    split and in the replicated dispatch (an odd S), its capacity factor
    E/k so that nothing drops and tp m computes what tp 1 does, every
    gradient (the router's included) against tp 1's.  ``spec["parts"]``
    picks "tp" (the first four) and/or "moe".  Rank 0 writes each check's
    relative L2 error."""
    import torch
    ctx, tp = _tp_ctx(world)
    g = torch.Generator().manual_seed(spec["seed"])
    errs = {}
    b, s, d, f = 2, 8, 16, 32
    if "tp" in spec["parts"]:
        errs.update(_tp_checks(rank, world, ctx, tp, g, (b, s, d, f)))
    if "moe" in spec["parts"]:
        errs.update(_moe_checks(rank, world, ctx, tp, g, (b, d, f)))
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(errs, fh)


def _tp_checks(rank, world, ctx, tp, g, dims) -> dict:
    import torch
    from repro_torch.models import layers as L
    from repro_torch.sharding import (copy_to_tp, gather_seq, mesh_context,
                                      reduce_from_tp, split_seq)
    b, s, d, f = dims
    errs = {}

    def shard(t, dim):
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).detach().clone()

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    # dense col -> row, and the bare collectives
    x = torch.randn(b, s, d, generator=g)
    w1 = torch.randn(d, f, generator=g) / d ** 0.5
    w2 = torch.randn(f, d, generator=g) / f ** 0.5
    dy = torch.randn(b, s, d, generator=g)
    xs, a, c = leaf(x), leaf(w1), leaf(w2)
    y = torch.tanh(xs @ a) @ c
    y_grads = torch.autograd.grad((y * dy).sum(), (xs, a, c))
    xt, at, ct = leaf(x), leaf(shard(w1, 1)), leaf(shard(w2, 0))
    with mesh_context(ctx):
        h = torch.tanh(copy_to_tp(xt, tp) @ at)
        yt = reduce_from_tp(h @ ct, tp)
    t_grads = torch.autograd.grad((yt * dy).sum(), (xt, at, ct))
    errs["dense_fwd"] = _rel_err(yt, y)
    errs["dense_dx"] = _rel_err(t_grads[0], y_grads[0])
    errs["dense_dw_col"] = _rel_err(t_grads[1], shard(y_grads[1], 1))
    errs["dense_dw_row"] = _rel_err(t_grads[2], shard(y_grads[2], 0))
    # dense() itself with gather= on Dense modules
    p1, p2 = L.Dense(d, f, True), L.Dense(f, d)
    p1.w.data, p1.b.data, p2.w.data = w1, torch.randn(f, generator=g), w2
    want = L.dense(p2, torch.tanh(L.dense(p1, x)))
    q1, q2 = L.Dense(d, f // world, True), L.Dense(f // world, d)
    q1.w.data, q1.b.data = shard(w1, 1), shard(p1.b, 0)
    q2.w.data = shard(w2, 0)
    with mesh_context(ctx):
        got = L.dense(q2, torch.tanh(L.dense(q1, x, "col")), "row")
    errs["dense_gather"] = _rel_err(got, want)
    # split_seq / gather_seq
    xs = leaf(x)
    wpos = torch.arange(1.0, s + 1)[None, :, None]
    want_g = torch.autograd.grad((torch.sin(xs) * wpos).sum(), xs)[0]
    xt = leaf(x)
    with mesh_context(ctx):
        part = split_seq(xt, tp)
        whole = gather_seq(torch.sin(part), tp)
    errs["seq_fwd"] = _rel_err(whole, torch.sin(x))
    errs["seq_shape"] = float(tuple(part.shape) != (b, s // world, d))
    errs["seq_dx"] = _rel_err(torch.autograd.grad((whole * wpos).sum(),
                                                  xt)[0], want_g)
    # a SwiGLU block at tp m against tp 1
    blk = L.SwiGLU(d, f, g, "cpu").requires_grad_(True)
    names = ("wi.w", "wg.w", "wo.w")
    cut = {"wi.w": 1, "wg.w": 1, "wo.w": 0}
    xs = leaf(x)
    y1 = L.swiglu(blk, xs)
    g1 = torch.autograd.grad((y1 * dy).sum(), [xs] + [
        blk.get_parameter(n) for n in names])
    loc = L.SwiGLU(d, f // world, None, "cpu")
    for n in names:
        loc.get_submodule(n[:-2])._parameters["w"] = torch.nn.Parameter(
            shard(blk.get_parameter(n), cut[n]), requires_grad=True)
    xt = leaf(x)
    with mesh_context(ctx):
        ym = L.swiglu(loc, xt)
    gm = torch.autograd.grad((ym * dy).sum(), [xt] + [
        loc.get_parameter(n) for n in names])
    errs["swiglu_fwd"] = _rel_err(ym, y1)
    errs["swiglu_dx"] = _rel_err(gm[0], g1[0])
    for i, n in enumerate(names):
        errs[f"swiglu_d{n}"] = _rel_err(gm[i + 1], shard(g1[i + 1], cut[n]))
    return errs


def _moe_checks(rank, world, ctx, tp, g, dims) -> dict:
    """An MoE block, token-parallel and replicated, at tp m against tp 1."""
    import dataclasses as dc
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import mesh_context
    b, d, f = dims
    errs = {}

    def shard(t, dim):
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).detach().clone()

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    base = MOE.MoEConfig(d_model=d, n_experts=8, top_k=2, d_ff_expert=f,
                         n_shared=1, d_ff_shared=2 * f)
    cfg = dc.replace(base, capacity_factor=base.n_experts / base.top_k)
    moe = MOE.MoE(cfg, g, "cpu").requires_grad_(True)
    split = {"wi": 0, "wg": 0, "wo": 0, "shared.wi.w": 1, "shared.wg.w": 1,
             "shared.wo.w": 0, "router.w": None}
    for label, seq in (("moe_split", 8), ("moe_replicated", 7)):
        xm = torch.randn(b, seq, d, generator=g)
        dym = torch.randn(b, seq, d, generator=g)
        named = dict(moe.named_parameters())
        xs = leaf(xm)
        y1 = MOE.moe_ffn(moe, xs, cfg)
        g1 = torch.autograd.grad((y1 * dym).sum(), [xs, *named.values()])
        loc = MOE.MoE(cfg, None, "cpu")
        for n, prm in named.items():
            owner, _, lf = n.rpartition(".")
            mod = loc.get_submodule(owner) if owner else loc
            t = prm if split[n] is None else shard(prm, split[n])
            mod._parameters[lf] = torch.nn.Parameter(t.detach().clone(),
                                                     requires_grad=True)
        xt = leaf(xm)
        with mesh_context(ctx), MOE.counting_drops() as drops:
            ym = MOE.moe_ffn(loc, xt, cfg)
        gm = torch.autograd.grad((ym * dym).sum(),
                                 [xt, *dict(loc.named_parameters()).values()])
        errs[f"{label}_fwd"] = _rel_err(ym, y1)
        errs[f"{label}_drops"] = float(sum(MOE.drop_counts(drops)))
        errs[f"{label}_dx"] = _rel_err(gm[0], g1[0])
        for i, n in enumerate(named):
            want = g1[i + 1] if split[n] is None else shard(g1[i + 1],
                                                            split[n])
            errs[f"{label}_d{n}"] = _rel_err(gm[i + 1], want)
    return errs


def _exchange_case(rank, world, spec, out):
    """The port's ``_dispatch_combine`` on (data, model) = (1, world):
    each rank its contiguous T/m slice of the input's tokens, the whole
    router, its E/m experts' rows; each rank writes its output and its
    kept slots."""
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import mesh_context
    ctx, tp = _tp_ctx(world)
    z = np.load(spec["inputs"])
    cfg = MOE.MoEConfig(**spec["moe"])
    t = z["x"].shape[0] // world
    e = cfg.n_experts // world

    def mine(a, n):
        return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1)
                                                       * n]))
    with mesh_context(ctx), torch.no_grad():
        y, keep = MOE._dispatch_combine(
            mine(z["x"], t), torch.from_numpy(z["router"]),
            mine(z["wi"], e), mine(z["wg"], e), mine(z["wo"], e), cfg, tp)
    np.savez(f"{out}.rank{rank}.npz", y=y.numpy(), keep=keep.numpy())


def _refusals_case(rank, world, spec, out):
    """One plain step of each ``spec["archs"]`` config on (data, model) =
    ``spec["mesh"]``, recording the ``PlanError`` it raises (or that it
    ran)."""
    import torch
    from repro_torch.kernels.build import PlanError
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, make_ctx
    from repro_torch.train import AdamW, make_train_step
    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"), "cpu")
    ctx = make_ctx(mesh)
    seen = {}
    for arch in spec["archs"]:
        cfg = port_cfg(arch)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        distribute(model, param_specs(cfg), mesh)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (2, spec["seq"] + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["enc_embeds"] = np.zeros((2, spec["seq"], cfg.d_model),
                                           np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = np.zeros((2, cfg.n_patches,
                                              cfg.d_model), np.float32)
        opt = AdamW()
        try:
            make_train_step(cfg, opt, ctx=ctx)(model, opt.init(model), batch)
            seen[arch] = "ran"
        except PlanError as exc:
            seen[arch] = "PlanError: " + str(exc)
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(seen, fh)


def _tp_restore_case(rank, world, spec, out):
    """Checkpoints across (data, model) meshes.  ``spec["one_rank"]`` holds
    a one-rank save (vid 0) of ``spec["arch"]``'s SMOKE parameters in the
    trainer's layout; it is restored (``restore(mesh=, specs=)`` and
    ``elastic_reshard``) onto each of ``spec["meshes"]`` and compared leaf
    for leaf; a restore onto ``spec["save_from"]`` is saved again from all
    its ranks into ``spec["saved"]``; ``spec["back"]`` (a save from
    another mesh) is restored onto this one's first mesh.  Rank 0 writes
    what it saw."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import reference_like
    from repro_torch.models.convert import reference_specs
    from repro_torch.models.transformer import abstract_params, param_specs
    from repro_torch.sharding import local, whole
    from repro_torch.train import CheckpointStore, elastic_reshard
    cfg = port_cfg(spec["arch"])
    like = reference_like(abstract_params(cfg))
    specs = reference_specs(param_specs(cfg))
    store = CheckpointStore(spec["one_rank"], shard_rows=1 << 10)
    want = flat(store.restore(0, treedef_like=like))
    seen = {"bitexact": {}, "shares": {}}
    for shape in spec["meshes"]:
        key = "x".join(map(str, shape))
        mesh = make_mesh(tuple(shape), ("data", "model"), "cpu")
        for how in ("restore", "elastic_reshard"):
            tree = (store.restore(0, mesh=mesh, specs=specs,
                                  treedef_like=like) if how == "restore"
                    else elastic_reshard(store, 0, mesh, specs,
                                         treedef_like=like))
            got = flat(tree)
            seen["bitexact"][f"{key}/{how}"] = all(
                np.array_equal(whole(got[k]).numpy(), want[k])
                and got[k].device_mesh == mesh for k in want)
        seen["shares"][key] = {k: [int(local(v).numel()), int(v.numel())]
                               for k, v in got.items()}
        if shape == spec.get("save_from"):
            CheckpointStore(spec["saved"], shard_rows=1 << 10).save(
                step=1, tree=tree, meta={"cursor": 1})
    if spec.get("back"):
        mesh = make_mesh(tuple(spec["meshes"][0]), ("data", "model"), "cpu")
        back = flat(elastic_reshard(CheckpointStore(spec["back"],
                                                    shard_rows=1 << 10),
                                    0, mesh, specs, treedef_like=like))
        seen["back_bitexact"] = all(np.array_equal(whole(back[k]).numpy(),
                                                   want[k]) for k in want)
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(seen, fh)


def _tp_calls_case(rank, world, spec, out):
    """One plain step of DeepSeek-V2-Lite's SMOKE config (``spec["layers"]``
    layers, ``spec["microbatches"]``) on (data, model) = (1, world), with
    and without remat: the model group's collective calls by kind
    (``sharding.TP_CALLS``; remat's recompute apart), which rank 0
    writes."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import (TP_CALLS, distribute, make_ctx,
                                      zero_tp_calls)
    from repro_torch.train import AdamW, make_train_step
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    seen = {}
    for remat in (False, True):
        cfg = dataclasses.replace(port_cfg("deepseek_v2_lite_16b"),
                                  n_layers=spec["layers"], remat=remat,
                                  microbatches=spec["microbatches"])
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        distribute(model, param_specs(cfg), mesh)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 65)).astype(np.int32)
        opt = AdamW()
        zero_tp_calls()
        make_train_step(cfg, opt, ctx=make_ctx(mesh))(
            model, opt.init(model), {"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]})
        seen[str(remat)] = dict(TP_CALLS)
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(seen, fh)


def _remat_thread_case(rank, world, spec, out):
    """A DeepSeek-V2-Lite SMOKE MoE block (latent attention, routed and
    shared experts) on (data, model) = (1, world) under remat, its forward
    on this thread and its backward on another (as the card's autograd
    engine runs a CUDA backward on its device thread, where the forward's
    thread-local mesh context is not set), against the same block without
    remat differentiated here: rank 0 writes each gradient's relative L2
    error."""
    import threading
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, make_ctx, mesh_context
    from repro_torch.train.train_step import cast_and_gather_params
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    ctx = make_ctx(mesh)
    cfg = port_cfg("deepseek_v2_lite_16b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        trainable=True)
    distribute(model, param_specs(cfg), mesh)
    work = cast_and_gather_params(model, cfg, ctx)
    block = work.layers[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    dy = torch.randn(2, 16, cfg.d_model, generator=g)
    leaves = list(block.parameters())
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        xs = x.clone().requires_grad_(True)
        with mesh_context(ctx):
            y = T._maybe_remat(T._attn_block_apply, c)(block, xs)

        def backward(y=y, xs=xs, remat=remat):
            grads[remat] = torch.autograd.grad((y * dy).sum(), [xs, *leaves])
        if remat:
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        else:
            backward()
    errs = [_rel_err(a, b) for a, b in zip(grads[True], grads[False])]
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(errs, fh)


def _seq_attention_case(rank, world, spec, out):
    """The sequence-sharded attention on (data, model) = (1, world), float32,
    against the whole computation of the same seeded inputs (every rank
    draws them all): ``layers._sdpa`` with kv heads that do not divide the
    axis (so it takes ``_sdpa_seq_sharded``), its forward and the q, k and
    v gradients through a weighted loss, causal and not; and the decode
    merge (``merged_decode`` on this rank's slice of a cache) against the
    whole materialised decode.  Rank 0 writes each check's relative L2
    error and the model group's collectives."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.sharding import (TP_CALLS, mesh_context, zero_tp_calls)
    ctx, tp = _tp_ctx(world)
    g = torch.Generator().manual_seed(spec["seed"])
    b, s, h, hkv, dh = 2, 8 * world, 6, 3, 16
    errs = {}
    for causal in (True, False):
        q, k, v, w = (torch.randn(b, s, n, dh, generator=g)
                      for n in (h, hkv, hkv, h))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = L._sdpa_core(*leaves, causal, 0)
        want_g = torch.autograd.grad((want * w).sum(), leaves)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        zero_tp_calls()
        with mesh_context(ctx):
            taken = L.seq_sharded(s, s, hkv)
            got = L._sdpa(*leaves, causal, hkv)
        got_g = torch.autograd.grad((got * w).sum(), leaves)
        tag = "causal" if causal else "full"
        errs[f"{tag}_fwd"] = _rel_err(got, want)
        for name, a, c in zip("qkv", got_g, want_g):
            errs[f"{tag}_d{name}"] = _rel_err(a, c)
        errs[f"{tag}_taken"] = float(not taken)
        errs[f"{tag}_calls"] = dict(TP_CALLS)
    # the decode merge: one query at position ``pos`` against a cache of
    # ``n`` positions, this rank's slice of them
    n, pos = 4 * world, 4 * world - 3
    q = torch.randn(b, 1, h, dh, generator=g)
    ck, cv = (torch.randn(b, n, hkv, dh, generator=g) for _ in range(2))
    want = ref.mha_ref(q, ck, cv, True, pos)
    part = n // world
    with mesh_context(ctx):
        got = L.merged_decode(q, ck[:, rank * part:(rank + 1) * part],
                              cv[:, rank * part:(rank + 1) * part], pos,
                              rank * part, True, tp)
    errs["decode_fwd"] = _rel_err(got, want)
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(errs, fh)


def _ssd_layer_case(rank, world, spec, out):
    """An SSD layer (``spec["arch"]``'s SMOKE geometry, float32) on (data,
    model) = (1, world), each rank its heads' working columns
    (``models.ssd.head_columns``) and slices, against the whole layer on
    one device: the forward, dx and every leaf's gradient (the whole
    gradient's columns for the regrouped leaves, B and C whole on every
    rank), then one decode step from seeded states (y, this rank's heads
    of ``h``, the whole conv state).  Rank 0 writes each check's relative
    L2 error."""
    import torch
    from repro_torch.models import ssd as SSD
    from repro_torch.sharding import mesh_context
    ctx, tp = _tp_ctx(world)
    cfg = port_cfg(spec["arch"]).ssd
    g = torch.Generator().manual_seed(spec["seed"])
    errs = {}
    with _f32(True):
        whole = SSD.SSD(cfg, g, "cpu").requires_grad_(True)
        for name in ("A_log", "dt_bias", "conv_b", "norm"):
            whole.get_parameter(name).data.normal_(0.0, 0.3, generator=g)
        heads, di = cfg.n_heads // world, cfg.d_inner // world
        cols = {"in_proj.w": SSD.head_columns(cfg, world, rank, "in_proj"),
                "conv_w": SSD.head_columns(cfg, world, rank, "conv"),
                "conv_b": SSD.head_columns(cfg, world, rank, "conv")}
        sl = {"A_log": slice(rank * heads, (rank + 1) * heads),
              "D": slice(rank * heads, (rank + 1) * heads),
              "dt_bias": slice(rank * heads, (rank + 1) * heads),
              "norm": slice(rank * di, (rank + 1) * di)}

        def mine(name, t):
            if name in cols:
                return t.index_select(-1, cols[name])
            if name in sl:
                return t[sl[name]]
            if name == "out_proj.w":
                return t[rank * di:(rank + 1) * di]
            return t

        part = SSD.SSD(cfg, None, "cpu")
        for name, prm in whole.named_parameters():
            owner, _, leaf = name.rpartition(".")
            mod = part.get_submodule(owner) if owner else part
            mod._parameters[leaf] = torch.nn.Parameter(
                mine(name, prm.detach()).clone(), requires_grad=True)
        x = torch.randn(2, 2 * cfg.chunk, cfg.d_model, generator=g)
        dy = torch.randn(2, 2 * cfg.chunk, cfg.d_model, generator=g)
        xs = x.clone().requires_grad_(True)
        y1, h1 = SSD.ssd_forward(whole, xs, cfg)
        names = [n for n, _ in whole.named_parameters()]
        g1 = torch.autograd.grad((y1 * dy).sum(), [xs, *whole.parameters()])
        xt = x.clone().requires_grad_(True)
        with mesh_context(ctx):
            ym, hm = SSD.ssd_forward(part, xt, cfg)
        gm = torch.autograd.grad((ym * dy).sum(), [xt, *part.parameters()])
        errs["fwd"] = _rel_err(ym, y1)
        errs["state"] = _rel_err(hm, h1[:, rank * heads:(rank + 1) * heads])
        errs["dx"] = _rel_err(gm[0], g1[0])
        for i, n in enumerate(names):
            errs[f"d{n}"] = _rel_err(gm[i + 1], mine(n, g1[i + 1]))
        # one decode step from seeded states
        st = {"h": torch.randn(2, cfg.n_heads, cfg.headdim, cfg.d_state,
                               generator=g) * 0.5,
              "conv": torch.randn(2, cfg.conv_width - 1, cfg.conv_dim,
                                  generator=g) * 0.5}
        x1 = torch.randn(2, 1, cfg.d_model, generator=g)
        with torch.no_grad():
            yd, sd = SSD.ssd_decode_step(whole, x1, cfg, st)
            with mesh_context(ctx):
                ydm, sdm = SSD.ssd_decode_step(part, x1, cfg, {
                    "h": st["h"][:, rank * heads:(rank + 1) * heads],
                    "conv": st["conv"]})
        errs["decode_y"] = _rel_err(ydm, yd)
        mine_h = sd["h"][:, rank * heads:(rank + 1) * heads]
        errs["decode_h"] = _rel_err(sdm["h"], mine_h)
        errs["decode_conv"] = _rel_err(sdm["conv"], sd["conv"])
    if rank == 0:
        with open(out + ".json", "w") as fh:
            json.dump(errs, fh)


def _all_rows(t, ctx):
    """The global batch from each (pod, data) line's rows (an all-gather
    over the batch axes, in rank order)."""
    import torch
    import torch.distributed as dist
    for a in reversed(ctx.dp):
        if a in ctx.mesh.mesh_dim_names and ctx.size(a) > 1:
            parts = [torch.empty_like(t) for _ in range(ctx.size(a))]
            dist.all_gather(parts, t.contiguous(), group=ctx.group(a))
            t = torch.cat(parts)
    return t


def _serve_case(rank, world, spec, out):
    """Serving on (data, model) = ``spec["mesh"]``: the parameters laid out
    by ``param_specs``, ``make_prefill_step`` on the global prompts, then
    ``spec["steps"]`` ``make_serve_step`` decodes from the test's seeded
    cache (``shard_cache``), each step's tokens the argmax of the last
    (gathered over the batch axes), and ``greedy_decode`` from the same
    cache.  Every rank writes its rows' prefill logits, each step's
    logits, its cache after the last step and its local shapes."""
    import torch
    from repro_torch.kernels.build import PlanError
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import from_reference
    from repro_torch.models.transformer import (cache_specs, init_cache,
                                                param_specs, shard_cache)
    from repro_torch.serve.serve_step import (greedy_decode,
                                              make_prefill_step,
                                              make_serve_step)
    from repro_torch.sharding import (TP_CALLS, distribute, make_ctx,
                                      zero_tp_calls)
    cfg = port_cfg(spec["arch"])
    z = np.load(spec["inputs"])
    weights = nest({k[2:]: z[k] for k in z.files if k.startswith("w/")})
    dev = spec.get("device", "cpu")
    mesh = make_mesh(tuple(spec["mesh"]), ("data", "model"), dev)
    ctx = make_ctx(mesh)
    with _f32(True):
        dtype = torch.float32
        model = from_reference(cfg, weights, device=dev)
        distribute(model, param_specs(cfg), mesh)
        prompt = torch.from_numpy(z["prompt"])
        whole = {k[6:]: (int(z[k]) if k == "cache/len" else
                         torch.from_numpy(z[k]).to(dev, dtype))
                 for k in z.files if k.startswith("cache/")}
        inputs = {k: torch.from_numpy(z[k]) for k in
                  ("tokens", "enc_embeds", "patch_embeds") if k in z.files}
        inputs["tokens"] = prompt
        zero_tp_calls()
        pre = make_prefill_step(cfg, ctx, device=dev)(model, inputs)
        calls = {"prefill": dict(TP_CALLS)}
        step = make_serve_step(cfg, ctx, device=dev)
        cache = shard_cache(whole, cfg, ctx)
        shapes = {k: list(t.shape) for k, t in cache.items() if k != "len"}
        b, max_len = prompt.shape[0], spec["max_len"]
        fresh = {k: list(t.shape) for k, t in init_cache(
            cfg, b, max_len, device=dev, ctx=ctx).items() if k != "len"}
        try:
            init_cache(cfg, b, max_len + 2, device=dev, ctx=ctx)
            uneven = "ran"
        except PlanError as exc:
            uneven = "PlanError: " + str(exc)
        tok = prompt[:, -1:].to(dev)
        logits, toks, convs = [], [], []
        zero_tp_calls()
        for _ in range(spec["steps"]):
            lg, cache = step(model, {"tokens": tok, "cache": cache})
            logits.append(lg.cpu().numpy())
            mine = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            toks.append(mine.cpu().numpy())
            if "conv" in cache:
                convs.append(cache["conv"].cpu().numpy())
            tok = _all_rows(mine, ctx)
        calls["decode"] = dict(TP_CALLS)
        greedy, _ = greedy_decode(model, cfg, ctx, prompt, spec["steps"],
                                  shard_cache(whole, cfg, ctx), device=dev)
    arrays = {"prefill": pre.cpu().numpy(), "greedy": greedy.cpu().numpy(),
              "tokens": np.concatenate(toks, axis=1),
              **{f"logits{i}": a for i, a in enumerate(logits)},
              **{f"conv{i}": a for i, a in enumerate(convs)},
              **{"cache/" + k: t.cpu().numpy() for k, t in cache.items()
                 if k != "len"}}
    np.savez(f"{out}.rank{rank}.npz", **arrays)
    with open(f"{out}.rank{rank}.json", "w") as fh:
        json.dump({"shapes": shapes, "fresh": fresh, "uneven": uneven,
                   "len": int(cache.get("len", -1)),
                   "dp_rank": ctx.dp_rank, "tp_rank":
                   mesh.get_local_rank("model"), "calls": calls,
                   "specs": {k: [list(e) if isinstance(e, tuple) else e
                                 for e in v]
                             for k, v in cache_specs(cfg, prompt.shape[0])
                             .items()}}, fh)


def patched_production(shapes: dict):
    """``launch.mesh.PRODUCTION`` with each kind's shape replaced by
    ``shapes[kind]`` (the axes kept); returns the original."""
    from repro_torch.launch import mesh as M
    kept = dict(M.PRODUCTION)
    for kind, shape in shapes.items():
        M.PRODUCTION[kind] = (tuple(shape), kept[kind][1])
    return kept


def _direct_losses(spec, argv_kw, mesh_kind, compress):
    """``make_train_step`` called directly on the production mesh with the
    train launcher's model, optimizer and batches: the losses."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, make_ctx
    from repro_torch.train import (AdamW, cosine_schedule, ef_init,
                                   make_train_step)
    cfg = T.reduced_config(configs.get(spec["arch"]))
    ctx = make_ctx(make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device="cpu"))
    ds, vid = T.corpus(cfg, seq=argv_kw["seq"], seed=0, device="cpu",
                       log=T._quiet)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        trainable=True)
    distribute(model, param_specs(cfg), ctx.mesh)
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=10,
                                   total=argv_kw["steps"]))
    state = opt.init(model)
    step = make_train_step(cfg, opt, grad_compress=compress, ctx=ctx)
    ef = ef_init(model, ctx.size("pod"), ctx) if compress else None
    losses = []
    for b in ds.batches(vid=vid, global_batch=argv_kw["batch"], seed=1,
                        start_step=0, n_steps=argv_kw["steps"]):
        if ef is None:
            model, state, m = step(model, state, b)
        else:
            model, state, ef, m = step(model, state, ef, b)
        losses.append(float(m["loss"]))
    return losses


def _production_launchers_case(rank, world, spec, out):
    """The launchers on the production meshes, their shapes patched to
    ``spec["shapes"]`` (this group's ranks): ``launch.train --mesh
    single``, ``--mesh multi`` and ``--mesh multi --grad-compress``, each
    beside ``make_train_step`` called directly on that mesh, then
    ``launch.serve --mesh single`` in float32 beside the one-device serve
    of this rank's rows; and the unpatched meshes refused on this group.
    Each rank writes what it saw."""
    import contextlib
    import io
    from repro_torch.kernels.build import PlanError
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_production_mesh
    os.environ["WORLD_SIZE"] = str(world)
    seen = {"refused": []}
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
            seen["refused"].append("ran")
        except PlanError as exc:
            seen["refused"].append(str(exc))
    kept = patched_production(spec["shapes"])
    try:
        kw = spec["train"]
        for mesh_kind, compress in (("single", False), ("multi", False),
                                    ("multi", True)):
            argv = ["--arch", spec["arch"], "--reduced", "--device", "cpu",
                    "--mesh", mesh_kind, "--steps", str(kw["steps"]),
                    "--batch", str(kw["batch"]), "--seq", str(kw["seq"]),
                    "--ckpt-every", "0", "--ckpt-dir",
                    f"{out}.ckpt{rank}-{mesh_kind}{int(compress)}"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                T.main(argv + (["--grad-compress"] if compress else []))
            lines = buf.getvalue().strip().splitlines()
            name = mesh_kind + ("_compressed" if compress else "")
            seen[name] = {
                "launcher": json.loads(lines[-1])["losses"] if lines else None,
                "printed": len(lines),
                "direct": _direct_losses(spec, kw, mesh_kind, compress)}
        kept_serve, runs = S.serve, []

        def recording(*a, **k):
            runs.append(kept_serve(*a, **k))
            return runs[-1]

        sv = spec["serve"]
        argv = ["--arch", sv["arch"], "--reduced", "--device", "cpu",
                "--mesh", "single", "--requests", str(sv["requests"]),
                "--prompt-len", str(sv["prompt_len"]), "--decode-steps",
                str(sv["decode_steps"])]
        S.serve = recording
        try:
            with _f32(True), contextlib.redirect_stdout(io.StringIO()) as buf:
                rc = S.main(argv)
                from repro_torch import configs
                cfg = T.reduced_config(configs.get(sv["arch"]))
                alone = kept_serve(cfg, requests=sv["requests"],
                                   prompt_len=sv["prompt_len"],
                                   decode_steps=sv["decode_steps"],
                                   device="cpu", log=T._quiet)
        finally:
            S.serve = kept_serve
        data, model = spec["shapes"]["single"]
        seen["serve"] = {"rc": rc, "dp_rank": rank // model, "dp": data,
                         "printed": len(buf.getvalue().strip().splitlines())}
        np.savez(f"{out}.serve{rank}.npz",
                 mesh=runs[0]["prefill_logits"].numpy(),
                 alone=alone["prefill_logits"].numpy())
    finally:
        from repro_torch.launch import mesh as M
        M.PRODUCTION.update(kept)
    with open(f"{out}.rank{rank}.json", "w") as fh:
        json.dump(seen, fh)


def run_cases(rank, world, cases):
    """Each ``(kind, spec, out)`` of ``cases`` in order on this group."""
    for kind, spec, out in cases:
        {"plain": _plain_case, "compressed": _compressed_case,
         "launcher": _launcher_case, "collectives": _collectives_case,
         "exchange": _exchange_case, "refusals": _refusals_case,
         "tp_restore": _tp_restore_case, "tp_calls": _tp_calls_case,
         "remat_thread": _remat_thread_case,
         "seq_attention": _seq_attention_case, "ssd_layer": _ssd_layer_case,
         "serve": _serve_case,
         "production_launchers": _production_launchers_case}[kind](
             rank, world, spec, out)


# ---------------------------------------------------------- reference ----
def reference_main(cases_path: str, out_path: str) -> None:
    """The reference side of the cases (run in a subprocess whose
    XLA_FLAGS fake four host devices), into ``out_path``: for a "plain"
    case its jitted step on the mesh (data, model) (model 1 unless the case
    names it), the losses, grad norms and parameters after the steps; for
    an "oracle" case, per pod, its ``accumulate_grads`` on the pod's rows
    of the first batch and ``quantize_int8`` of each leaf, and the mean of
    the pods' losses; for an "exchange" case its ``_dispatch_combine`` in
    ``shard_map`` over a model axis of ``model`` (the tokens' rows split
    over it, the experts' rows too), the output and, recomputed from the
    same routing and its ``_capacity``, each rank's kept slots.  The steps
    compile in threads (XLA compiles outside the GIL), then run in turn."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from repro import configs as RC
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import _make_mesh
    from repro.models import layers as RL
    from repro.models import moe as RM
    from repro.sharding import compat_shard_map
    from repro.models.transformer import ArchConfig, param_specs
    from repro.sharding import logical_to_sharding, make_ctx
    from repro.train import AdamW
    from repro.train.train_step import (accumulate_grads, make_train_step,
                                        quantize_int8)
    with open(cases_path) as f:
        cases = json.load(f)

    def config(spec):
        if spec["arch"] == "tiny":
            cfg = ArchConfig(name="tiny-ft", family="dense", n_layers=2,
                             d_model=64, n_heads=4, n_kv=2, d_ff=128,
                             vocab=256, head_dim=16, tie_embeddings=True,
                             remat=False, microbatches=1)
        else:
            cfg = RC.smoke(spec["arch"])
        return dataclasses.replace(cfg, microbatches=spec.get(
            "microbatches", 1))

    def dtype(spec):
        return jnp.float32 if spec["f32"] else jnp.bfloat16

    jobs = {}
    for name, spec in cases.items():
        cfg = config(spec)
        RL.COMPUTE_DTYPE = dtype(spec)       # read while tracing
        weights, batches = load_inputs(spec["inputs"])
        params = jax.tree.map(jnp.asarray, weights)
        if spec.get("kind", "plain") == "oracle":
            rows = batches[0]["tokens"].shape[0] // spec["pods"]
            args = [(params, {k: jnp.asarray(v[p * rows:(p + 1) * rows])
                              for k, v in batches[0].items()})
                    for p in range(spec["pods"])]
            fn = jax.jit(lambda p, b, cfg=cfg: accumulate_grads(p, b, cfg))
            jobs[name] = (fn.lower(*args[0]), args, None)
            continue
        if spec.get("kind") == "serve":
            jobs[name] = (None, (cfg, spec), "serve")
            continue
        if spec.get("kind") == "exchange":
            z = np.load(spec["inputs"])
            mcfg = RM.MoEConfig(**spec["moe"])
            mesh = _make_mesh((1, spec["model"]), ("data", "model"))

            def per_rank(x, rw, wi, wg, wo, mcfg=mcfg):
                y = RM._dispatch_combine(x, rw, wi, wg, wo, cfg=mcfg,
                                         model_axis="model")
                # the kept slots, from the same routing and capacity
                t = x.shape[0]
                logits = x.astype(jnp.float32) @ rw.astype(jnp.float32)
                top_e = jax.lax.top_k(jax.nn.softmax(logits, -1),
                                      mcfg.top_k)[1]
                flat_e = top_e.reshape(-1)
                sorted_e = flat_e[jnp.argsort(flat_e, stable=True)]
                counts = jnp.bincount(flat_e, length=mcfg.n_experts)
                rank = jnp.arange(t * mcfg.top_k) - (jnp.cumsum(counts)
                                                     - counts)[sorted_e]
                return y, rank < RM._capacity(t, mcfg)

            fn = jax.jit(compat_shard_map(
                per_rank, mesh=mesh,
                in_specs=(P("model", None), P(None, None),
                          P("model", None, None), P("model", None, None),
                          P("model", None, None)),
                out_specs=(P("model", None), P("model")), check_vma=False))
            args = tuple(jnp.asarray(z[k]) for k in ("x", "router", "wi",
                                                     "wg", "wo"))
            jobs[name] = (fn.lower(*args), args, "exchange")
            continue
        mesh = _make_mesh((spec["data"], spec.get("model", 1)),
                          ("data", "model"))
        opt = AdamW(lr=spec["lr"])
        params = jax.device_put(params,
                                logical_to_sharding(param_specs(cfg), mesh))
        state = opt.init(params)
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in batches[:spec["steps"]]]
        fn = jax.jit(make_train_step(cfg, make_ctx(mesh), opt))
        jobs[name] = (fn.lower(params, state, bs[0]), (params, state), bs)
    def prepare(job):
        lowered, args, kind = job
        if kind == "serve":                 # compiles and runs here
            return _reference_serve(*args)
        return lowered.compile()

    if any(kind == "serve" for _, _, kind in jobs.values()):
        assert all(spec["f32"] for spec in cases.values()
                   if spec.get("kind") == "serve")
        RL.COMPUTE_DTYPE = jnp.float32  # the serve cases trace in the pool
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = dict(zip(jobs, pool.map(prepare, jobs.values())))
    out = {}
    for name, (_, args, bs) in jobs.items():
        step = compiled[name]
        if bs == "serve":
            out.update({f"{name}/{k}": v for k, v in step.items()})
            continue
        if bs == "exchange":
            y, keep = step(*args)
            out[f"{name}/y"], out[f"{name}/keep"] = (np.asarray(y),
                                                     np.asarray(keep))
            continue
        if bs is None:                                   # the oracle
            losses = []
            for p, a in enumerate(args):
                loss, g = step(*a)
                losses.append(float(loss))
                for k, v in flat(g).items():
                    q, scale = quantize_int8(v)
                    out[f"{name}/target{p}/{k}"] = np.asarray(v)
                    out[f"{name}/q{p}/{k}"] = np.asarray(q)
                    out[f"{name}/scale{p}/{k}"] = np.asarray(scale)
            out[f"{name}/loss"] = np.asarray([np.mean(losses)])   # pmean
            continue
        params, state = args
        losses, norms = [], []
        for b in bs:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{name}/loss"] = np.asarray(losses)
        out[f"{name}/gnorm"] = np.asarray(norms)
        for k, v in flat(jax.tree.map(np.asarray, params)).items():
            out[f"{name}/p/{k}"] = v
    np.savez(out_path, **out)
    print("REFERENCE_OK", jax.device_count())


def _reference_serve(cfg, spec) -> dict:
    """The reference's serving on (data, model) = (spec["data"],
    spec["model"]): ``make_prefill_step`` on the prompts, then
    ``spec["steps"]`` ``make_serve_step`` decodes from the test's cache laid
    out by ``cache_specs``, each step's tokens the argmax of the last.
    Returns the prefill's and each step's logits, the tokens and the cache
    after the last step (whole)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import _make_mesh
    from repro.models.transformer import cache_specs, param_specs
    from repro.serve.serve_step import make_prefill_step, make_serve_step
    from repro.sharding import logical_to_sharding, make_ctx
    z = np.load(spec["inputs"])
    weights = nest({k[2:]: z[k] for k in z.files if k.startswith("w/")})
    mesh = _make_mesh((spec["data"], spec["model"]), ("data", "model"))
    ctx = make_ctx(mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, weights),
                            logical_to_sharding(param_specs(cfg), mesh))
    prompt = jnp.asarray(z["prompt"])
    cache = {k[6:]: (jnp.asarray(z[k], jnp.int32) if k == "cache/len"
                     else jnp.asarray(z[k], jnp.float32))
             for k in z.files if k.startswith("cache/")}
    cache = jax.device_put(cache, logical_to_sharding(
        cache_specs(cfg, prompt.shape[0]), mesh))
    batch = {k: jnp.asarray(z[k]) for k in ("enc_embeds", "patch_embeds")
             if k in z.files}
    batch["tokens"] = prompt
    out = {"prefill": np.asarray(jax.jit(make_prefill_step(cfg, ctx))(
        params, batch))}
    step = jax.jit(make_serve_step(cfg, ctx))
    tok = prompt[:, -1:]
    toks = []
    for i in range(spec["steps"]):
        logits, cache = step(params, {"tokens": tok, "cache": cache})
        out[f"logits{i}"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    out["tokens"] = np.concatenate(toks, axis=1)
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()
                if k != "len"})
    return out


if __name__ == "__main__":
    reference_main(sys.argv[1], sys.argv[2])
