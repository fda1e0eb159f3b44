"""The port's expert parallelism on the mesh's model axis, across gloo
ranks on the CPU, against the JAX package on meshes of faked host devices
(``tests/torch_ranks.py``: the reference in one subprocess with four faked
host devices, the port's ranks in a gloo group over a ``file://`` store).
The card holds one NCCL rank, so the numerics across model ranks are held
here, as the reference holds its own on faked host devices.

* The exchange: the port's ``_dispatch_combine`` on 2 and 4 model ranks
  against the reference's, run in ``shard_map`` over a model axis of 2 and
  4, on the same float32 inputs (64 tokens a rank, OLMoE's SMOKE geometry,
  8 experts top-2, capacity factor 1.25, a router skewed towards expert 0
  so that slots drop): the kept and dropped slots identical on every rank,
  the outputs within ``EXCHANGE_TOL`` relative L2.
* The backward conjugates: an MoE block with a shared expert at tp 2 and 4
  against tp 1, float32, in the token-parallel split (S 8) and in the
  replicated dispatch (S 7), its capacity factor E/k so that nothing
  drops and tp m computes what tp 1 does: forward and every gradient (the
  router's, the experts' rows, the shared expert's shards, the input's)
  within ``COLLECTIVE_TOL``.  A gradient summed in ``gather_seq``'s
  backward, or a router gradient not summed over "model", is off by a
  factor, far past it.
* OLMoE's SMOKE config (8 experts, top-2, 4 kv heads), B 4, S 64, one
  plain step at (data, model) (1,2), (2,2) and (1,4), float32, against the
  reference's runs on the same meshes: loss and grad norm within 1e-5
  relative, every parameter within 1e-3 relative L2.  The model axis
  changes which slots drop (each model rank routes its S/m slice with its
  own capacity), so (1,2) differs from (1,1) by more than that; the
  port's one-device step equals the reference's (1,1) run.
* Each rank holds 1/tp of the expert leaves (and their AdamW moments).
* The model group's collective calls a step of DeepSeek-V2-Lite SMOKE
  (4 layers, 2 microbatches), by kind, are what
  ``chip_smoke.expected_tp_calls`` reckons (phase 25's proof that the
  path ran), with and without remat; a remat'd MoE block differentiated
  on another thread (as the card's autograd engine does) keeps the model
  axis in its recompute.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro import configs as RC
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch.models import from_reference
from repro_torch.train import AdamW, make_train_step

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TOL = 1e-6
EXCHANGE_TOL = 1e-6
LOSS_F32 = 1e-5
STEPS_F32 = 1e-3
LR = 1e-3
REFERENCE_TIMEOUT_S = 240
ARCH = "olmoe_1b_7b"
MESHES = [(1, 2), (2, 2), (1, 4)]
EXCHANGE_TOKENS = 64      # a model rank's tokens in the exchange case


def _key(mesh) -> str:
    return "x".join(map(str, mesh))


def _inputs(path, seed):
    tree = jax.tree.map(np.asarray, RT.init_params(RC.smoke(ARCH),
                                                   jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    toks = rng.integers(0, RC.smoke(ARCH).vocab, (4, 65)).astype(np.int32)
    arrays["tokens0"], arrays["labels0"] = toks[:, :-1], toks[:, 1:]
    np.savez(path, **arrays)
    return str(path)


def _exchange_inputs(path, m, seed):
    """Float32 tokens for m ranks, a router skewed towards expert 0, the
    experts' weights."""
    mcfg = RC.smoke(ARCH).moe
    e, d, f = mcfg.n_experts, mcfg.d_model, mcfg.d_ff_expert
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5
    router[:, 0] += 1.0
    np.savez(path, x=rng.standard_normal((m * EXCHANGE_TOKENS, d)).astype(
                 np.float32),
             router=router,
             wi=(rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
             wg=(rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
             wo=(rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32))
    return str(path), dict(d_model=d, n_experts=e, top_k=mcfg.top_k,
                           d_ff_expert=f,
                           capacity_factor=mcfg.capacity_factor)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    olmoe = _inputs(tmp / "olmoe.npz", 2)
    ref_cases = {f"olmoe_{_key(m)}": dict(arch=ARCH, inputs=olmoe, data=m[0],
                                          model=m[1], f32=True, lr=LR,
                                          steps=1)
                 for m in [(1, 1)] + MESHES}
    for m in (2, 4):
        path, moe = _exchange_inputs(tmp / f"exchange{m}.npz", m, 10 + m)
        ref_cases[f"exchange{m}"] = dict(kind="exchange", arch=ARCH,
                                         inputs=path, model=m, moe=moe,
                                         f32=True)
    (tmp / "cases.json").write_text(json.dumps(ref_cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ranks.py"),
         str(tmp / "cases.json"), str(tmp / "reference.npz")],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for world in (2, 4):
            cases = []
            for m in MESHES:
                if m[0] * m[1] == world:
                    name = f"olmoe_{_key(m)}"
                    port[name] = str(tmp / f"port_{name}")
                    cases.append(("plain", dict(ref_cases[name], mesh=m),
                                  port[name]))
            name = f"exchange{world}"
            port[name] = str(tmp / f"port_{name}")
            cases.append(("exchange", ref_cases[name], port[name]))
            port[f"moe{world}"] = str(tmp / f"moe{world}")
            cases.append(("collectives", dict(seed=world, parts=["moe"]),
                          port[f"moe{world}"]))
            port[f"calls{world}"] = str(tmp / f"calls{world}")
            cases.append(("tp_calls", dict(layers=4, microbatches=2),
                          port[f"calls{world}"]))
            port[f"remat{world}"] = str(tmp / f"remat{world}")
            cases.append(("remat_thread", {}, port[f"remat{world}"]))
            R.spawn(R.run_cases, world, tmp / f"w{world}", cases)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK 4" in out, err[-3000:]
    return {"tmp": tmp, "olmoe": olmoe, "port": port,
            "ref": dict(np.load(tmp / "reference.npz"))}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _port(runs, name):
    return dict(np.load(runs["port"][name] + ".npz"))


def _json(runs, name):
    return json.loads(Path(runs["port"][name] + ".json").read_text())


# -------------------------------------------------------- the exchange --
@pytest.mark.parametrize("m", [2, 4])
def test_exchange_matches_reference_dispatch_combine(runs, m):
    ranks = [dict(np.load(f"{runs['port'][f'exchange{m}']}.rank{r}.npz"))
             for r in range(m)]
    keep = np.concatenate([r["keep"] for r in ranks])
    y = np.concatenate([r["y"] for r in ranks])
    want_keep = runs["ref"][f"exchange{m}/keep"]
    np.testing.assert_array_equal(keep, want_keep)
    assert 0 < keep.sum() < keep.size          # slots kept and dropped
    assert _rel(y, runs["ref"][f"exchange{m}/y"]) <= EXCHANGE_TOL


# ------------------------------------------------ the backward conjugates --
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("split", ["moe_split", "moe_replicated"])
def test_moe_block_gradients_at_tp_m_equal_tp_1(runs, world, split):
    errs = json.loads(Path(runs["port"][f"moe{world}"] + ".json")
                      .read_text())
    assert errs.pop(f"{split}_drops") == 0
    mine = {k: v for k, v in errs.items() if k.startswith(split + "_")}
    assert {f"{split}_drouter.w", f"{split}_dwi", f"{split}_dx",
            f"{split}_fwd", f"{split}_dshared.wo.w"} <= set(mine)
    for k, v in mine.items():
        assert v <= COLLECTIVE_TOL, (k, v)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_model_group_collectives_are_as_chip_smoke_reckons(runs, world,
                                                           remat):
    """``chip_smoke.expected_tp_calls`` (phase 25's check that the TP/EP
    path ran, its reckoning on a model axis above 1 the sequence-sharded
    residual's and the vocabulary's) against the calls of a
    DeepSeek-V2-Lite SMOKE step at 4 layers and 2 microbatches, on 2 and 4
    model ranks, with and without remat (whose recompute counts apart)."""
    import dataclasses
    sys.path.insert(0, str(ROOT))
    from chip_smoke import expected_tp_calls
    cfg = dataclasses.replace(R.port_cfg("deepseek_v2_lite_16b"), n_layers=4,
                              remat=remat, microbatches=2)
    assert _json(runs, f"calls{world}")[str(remat)] == \
        expected_tp_calls(cfg, 1, world)


@pytest.mark.parametrize("world", [2, 4])
def test_remat_recompute_on_another_thread_keeps_the_model_axis(runs,
                                                                world):
    """A remat'd MoE block differentiated on another thread (the card's
    autograd engine runs a CUDA backward on its device thread, where the
    forward's thread-local mesh context is not set) gives the gradients of
    the same block without remat: the recompute re-enters the forward's
    context."""
    errs = _json(runs, f"remat{world}")
    assert len(errs) > 10
    assert max(errs) <= COLLECTIVE_TOL, errs


# ------------------------------------------------------ the plain steps --
@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_olmoe_step_matches_reference_on_the_model_axis(runs, mesh):
    name = f"olmoe_{_key(mesh)}"
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


def test_the_model_axis_changes_the_olmoe_step(runs, monkeypatch):
    """The port's one-device step equals the reference's (1,1) run, and
    (1,2) differs from it by more than the tolerance (each model rank's
    slice has its own capacity)."""
    from repro_torch.models import layers as TL
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = TC.smoke(ARCH)
    weights, batches = R.load_inputs(runs["olmoe"])
    model = from_reference(cfg, weights, device="cpu").requires_grad_(True)
    opt = AdamW(lr=LR)
    _, _, m = make_train_step(cfg, opt)(model, opt.init(model), batches[0])
    one = {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"])}
    ref = runs["ref"]
    got = _port(runs, "olmoe_1x2")
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(one[key], ref[f"olmoe_1x1/{key}"][0],
                                   rtol=LOSS_F32)
        assert abs(one[key] - got[key][0]) > LOSS_F32 * abs(one[key]), key


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_each_rank_holds_its_experts(runs, mesh):
    world = mesh[0] * mesh[1]
    for r in range(world):
        rank = json.loads(Path(f"{runs['port'][f'olmoe_{_key(mesh)}']}"
                               f".shards{r}.json").read_text())
        experts = [n for n in rank["params"] if n.split(".")[-1] in
                   ("wi", "wg", "wo") and ".moe." in n]
        assert experts
        for n in experts:
            for key in ("params", "m"):
                mine, whole = rank[key][n]
                assert mine * mesh[1] == whole, (key, n)
