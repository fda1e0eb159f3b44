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
    ``tokens<i>``/``labels<i>`` batches."""
    z = np.load(path)
    weights = nest({k[2:]: z[k] for k in z.files if k.startswith("w/")})
    batches = [{"tokens": z[f"tokens{i}"], "labels": z[f"labels{i}"]}
               for i in range(sum(k.startswith("tokens") for k in z.files))]
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
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
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
    from torch.distributed.device_mesh import init_device_mesh
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
              # the model axis is not trained on yet, so make_mesh refuses
              # it; a restore takes any mesh
              "1x2": init_device_mesh("cpu", (1, 2),
                                      mesh_dim_names=("data", "model"))}
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


def run_cases(rank, world, cases):
    """Each ``(kind, spec, out)`` of ``cases`` in order on this group."""
    for kind, spec, out in cases:
        {"plain": _plain_case, "compressed": _compressed_case,
         "launcher": _launcher_case}[kind](rank, world, spec, out)


# ---------------------------------------------------------- reference ----
def reference_main(cases_path: str, out_path: str) -> None:
    """The reference side of the cases (run in a subprocess whose
    XLA_FLAGS fake four host devices), into ``out_path``: for a "plain"
    case its jitted step on the mesh (data, 1), the losses, grad norms and
    parameters after the steps; for an "oracle" case, per pod, its
    ``accumulate_grads`` on the pod's rows of the first batch and
    ``quantize_int8`` of each leaf, and the mean of the pods' losses.  The
    steps compile in threads (XLA compiles outside the GIL), then run in
    turn."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from repro import configs as RC
    from repro.launch.mesh import _make_mesh
    from repro.models import layers as RL
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
        mesh = _make_mesh((spec["data"], 1), ("data", "model"))
        opt = AdamW(lr=spec["lr"])
        params = jax.device_put(params,
                                logical_to_sharding(param_specs(cfg), mesh))
        state = opt.init(params)
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in batches[:spec["steps"]]]
        fn = jax.jit(make_train_step(cfg, make_ctx(mesh), opt))
        jobs[name] = (fn.lower(params, state, bs[0]), (params, state), bs)
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = dict(zip(jobs, pool.map(lambda j: j[0].compile(),
                                           jobs.values())))
    out = {}
    for name, (_, args, bs) in jobs.items():
        step = compiled[name]
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


if __name__ == "__main__":
    reference_main(sys.argv[1], sys.argv[2])
