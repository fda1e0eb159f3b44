"""The port's tensor parallelism on the mesh's model axis, across gloo ranks
on the CPU, against the JAX package's steps on meshes of faked host
devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``repro.launch.mesh._make_mesh`` (Auto axes).  Both load the same
seeded weights and batches from an ``.npz`` this file writes.  The card
holds one NCCL rank, so the numerics across model ranks are held here, as
the reference holds its own on faked host devices.

* The collectives at tp 2 and 4, float32: ``copy_to_tp`` before a
  column-parallel product and ``reduce_from_tp`` after a row-parallel one
  (also through ``dense(gather="col"|"row")``), ``split_seq`` then
  ``gather_seq``, and a SwiGLU block: forward and every gradient equal the
  one-device computation within ``COLLECTIVE_TOL`` relative L2 (float32
  sums in another order).
* TINY (``tests/test_elastic_restart.py``'s config), B 4, S 32, two plain
  steps at (data, model) (1,2) and (2,2) against the reference's runs on
  the same meshes: in float32 (both packages' ``COMPUTE_DTYPE`` patched)
  the losses and grad norms within 1e-5 relative and every parameter leaf
  within 1e-3 relative L2 after the two AdamW steps (the bound of
  ``tests/test_torch_data_parallel.py``); in bf16 the losses and grad norms
  within ``launch.serve.prefill_bound`` relative, which is above the
  reference's own spread across meshes (3e-5 of the loss, ROADMAP §A).
* DeepSeek-V2-Lite's SMOKE config (latent attention, a dense layer, MoE
  layers with a shared expert), B 4, S 64, one step at (1,2) and (2,2),
  float32: loss and grad norm within 1e-5 relative, every parameter within
  1e-3 relative L2 of the reference's.
* The eval step at (1,2) and (2,2) equals the one-device eval of the same
  (gathered) parameters within 1e-5.
* The compressed step at (pod, data, model) = (2,1,2), float32, against
  the formula oracle (the reference's ``accumulate_grads`` and
  ``quantize_int8`` on each pod's rows; its own compressed step does not
  run on jax 0.9.0, ROADMAP C.2), held as
  ``tests/test_torch_data_parallel.py`` holds (2,1,1).
* Each rank holds 1/tp of every leaf (and AdamW moment) whose spec shards
  it over "model", 1/dp of every one sharded over "data".
* TINY at (1,4) (2 kv heads on 4 model ranks, the reference's
  sequence-sharded attention) and the ``ssm`` and ``hybrid`` families at
  tp 2 and 4, once refused with ``PlanError``, run a step (their numerics:
  ``tests/test_torch_seq_parallel.py``, ``tests/test_torch_ssd_parallel.py``).
* Checkpoints: a one-rank save of DeepSeek-V2-Lite SMOKE restored
  (``restore(mesh=, specs=)`` and ``elastic_reshard``) onto (1,2), (2,2)
  and (1,4) bit-exact, each rank holding its share; a save from the
  (1,2) layout equal to the one-rank save row for row, and restored onto
  (1,1) bit-exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro import configs as RC
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import from_reference, to_reference
from repro_torch.models.convert import reference_specs
from repro_torch.models.transformer import param_specs
from repro_torch.train import CheckpointStore

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TOL = 1e-6
LOSS_F32 = 1e-5
STEPS_F32 = 1e-3
LR = 1e-3
REF_SPREAD = 3e-5       # the reference's bf16 loss across TINY's meshes
E_TOL = 1e-3
HALF_POINT = 1e-3
FLIP_SHARE = 0.01
REFERENCE_TIMEOUT_S = 240
MESHES = [(1, 2), (2, 2)]
RESTORE_ARCH = "deepseek_v2_lite_16b"


def _ref_tiny():
    return RT.ArchConfig(name="tiny-ft", family="dense", n_layers=2,
                         d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                         head_dim=16, tie_embeddings=True, remat=False,
                         microbatches=1)


def _inputs(path, rcfg, seed, b, s, n_batches):
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    for i in range(n_batches):
        toks = rng.integers(0, rcfg.vocab, (b, s + 1)).astype(np.int32)
        arrays[f"tokens{i}"], arrays[f"labels{i}"] = toks[:, :-1], toks[:, 1:]
    np.savez(path, **arrays)
    return str(path)


def _key(mesh) -> str:
    return "x".join(map(str, mesh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    tiny = _inputs(tmp / "tiny.npz", _ref_tiny(), 1, 4, 32, 2)
    mla = _inputs(tmp / "mla.npz", RC.smoke(RESTORE_ARCH), 3, 4, 64, 1)
    ref_cases = {}
    for mesh in MESHES:
        for f32 in (True, False):
            ref_cases[f"tiny_{_key(mesh)}_{'f32' if f32 else 'bf16'}"] = \
                dict(arch="tiny", inputs=tiny, data=mesh[0], model=mesh[1],
                     f32=f32, lr=LR, steps=2)
        ref_cases[f"mla_{_key(mesh)}"] = dict(
            arch=RESTORE_ARCH, inputs=mla, data=mesh[0], model=mesh[1],
            f32=True, lr=LR, steps=1)
    ref_cases["oracle"] = dict(kind="oracle", arch="tiny", inputs=tiny,
                               f32=True, pods=2)
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
    # the one-rank save the restores start from
    model = from_reference(R.port_cfg(RESTORE_ARCH),
                           R.load_inputs(mla)[0], device="cpu")
    one = str(tmp / "ckpt_one")
    CheckpointStore(one, shard_rows=1 << 10).save(
        step=1, tree=to_reference(model, host=False), meta={"cursor": 1})
    saved = str(tmp / "ckpt_1x2")
    try:
        port = {}
        for world in (2, 4):
            cases = []
            for name, spec in ref_cases.items():
                mesh = (spec.get("data"), spec.get("model"))
                if spec.get("kind") is None and mesh[0] * mesh[1] == world:
                    port[name] = str(tmp / f"port_{name}")
                    cases.append(("plain", dict(spec, mesh=mesh),
                                  port[name]))
            port[f"collectives{world}"] = str(tmp / f"collectives{world}")
            cases.append(("collectives", dict(seed=world, parts=["tp"]),
                          port[f"collectives{world}"]))
            port[f"refusals{world}"] = str(tmp / f"refusals{world}")
            cases.append(("refusals", dict(
                mesh=(1, world), seq=32,
                archs=["tiny", "mamba2_780m", "zamba2_2_7b"]),
                port[f"refusals{world}"]))
            port[f"restore{world}"] = str(tmp / f"restore{world}")
            cases.append(("tp_restore", dict(
                arch=RESTORE_ARCH, one_rank=one, saved=saved,
                save_from=[1, 2],
                meshes=[[1, 2]] if world == 2 else [[2, 2], [1, 4]]),
                port[f"restore{world}"]))
            if world == 4:
                port["compressed"] = str(tmp / "port_compressed")
                cases.append(("compressed", dict(arch="tiny", inputs=tiny,
                                                 shape=(2, 1, 2), lr=LR),
                              port["compressed"]))
            R.spawn(R.run_cases, world, tmp / f"w{world}", cases)
        port["restore1"] = str(tmp / "restore1")
        R.spawn(R.run_cases, 1, tmp / "w1", [("tp_restore", dict(
            arch=RESTORE_ARCH, one_rank=one, meshes=[[1, 1]], back=saved),
            port["restore1"])])
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK 4" in out, err[-3000:]
    return {"tmp": tmp, "tiny": tiny, "mla": mla, "one": one,
            "saved": saved, "port": port,
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


# ------------------------------------------------------ the collectives --
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("part", ["dense", "seq", "swiglu"])
def test_collectives_match_the_whole_computation(runs, world, part):
    errs = {k: v for k, v in _json(runs, f"collectives{world}").items()
            if k.startswith(part)}
    assert len(errs) >= 3
    for k, v in errs.items():
        assert v <= COLLECTIVE_TOL, (k, v)


# ------------------------------------------------------ the plain steps --
@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_tiny_plain_step_matches_reference_f32(runs, mesh):
    name = f"tiny_{_key(mesh)}_f32"
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_tiny_plain_step_matches_reference_bf16(runs, mesh):
    name = f"tiny_{_key(mesh)}_bf16"
    bound = prefill_bound(R.tiny())
    assert bound >= REF_SPREAD
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=bound)


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_latent_attention_moe_step_matches_reference(runs, mesh):
    name = f"mla_{_key(mesh)}"
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_eval_step_on_the_model_axis_is_the_one_rank_eval(runs, mesh,
                                                         monkeypatch):
    from repro_torch.models import layers as TL
    from repro_torch.train import make_eval_step
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    got = _port(runs, f"tiny_{_key(mesh)}_f32")
    model = from_reference(R.tiny(), R.nest(
        {k[2:]: v for k, v in got.items() if k.startswith("p/")}),
        device="cpu")
    batch = R.load_inputs(runs["tiny"])[1][0]
    want = float(make_eval_step(R.tiny())(model, batch))
    np.testing.assert_allclose(got["eval"][0], want, rtol=LOSS_F32)


def _shards(runs, name, world):
    return [json.loads(Path(f"{runs['port'][name]}.shards{r}.json")
                       .read_text()) for r in range(world)]


def _axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


@pytest.mark.parametrize("arch", ["tiny", "mla"])
@pytest.mark.parametrize("mesh", MESHES, ids=_key)
def test_each_rank_holds_its_share_of_model_sharded_leaves(runs, arch, mesh):
    name = f"{arch}_{_key(mesh)}" + ("_f32" if arch == "tiny" else "")
    sizes = {"data": mesh[0], "model": mesh[1]}
    by_model = 0
    for rank in _shards(runs, name, mesh[0] * mesh[1]):
        for key in ("params", "m"):
            for n, (mine, whole) in rank[key].items():
                share = int(np.prod([sizes[a] for a in
                                     _axes(rank["specs"][n])]))
                assert mine * share == whole, (key, n, rank["specs"][n])
                by_model += "model" in _axes(rank["specs"][n])
    assert by_model > 0


# ------------------------------------------------- the compressed step --
def test_compressed_step_on_the_model_axis_matches_formula_oracle(runs):
    """(pod, data, model) = (2, 1, 2): the int8 exchange on TP shards, the
    residuals laid out by ``ef_specs`` (a rank holds its pod's row of its
    model shard), held as ``tests/test_torch_data_parallel.py`` holds
    (2, 1, 1)."""
    npods = 2
    got = _port(runs, "compressed")
    ref = runs["ref"]
    pods = [{key: {k.split("/", 2)[2]: v for k, v in ref.items()
                   if k.startswith(f"oracle/{key}{p}/")}
             for key in ("target", "q", "scale")} for p in range(npods)]
    for k in pods[0]["q"]:
        s = sum(o["q"][k].astype(np.int32) for o in pods)
        sc = max(o["scale"][k] for o in pods)
        ghat = s.astype(np.float32) * sc / np.float32(npods)
        assert np.abs(got["g/" + k] - ghat).max() <= sc / npods * 1.001, k
        for i, p in enumerate(pods):
            scale = float(p["scale"][k])
            res = p["target"][k] - p["q"][k].astype(np.float32) * scale
            diff = np.abs(got[f"e{i}/" + k] - res)
            flip = diff > 0.5 * scale
            assert diff[~flip].max(initial=0) <= E_TOL * scale, k
            x = p["target"][k][flip] / scale
            assert np.all(np.abs(np.abs(x - np.floor(x)) - 0.5)
                          <= HALF_POINT), k
            assert flip.sum() <= max(1, FLIP_SHARE * flip.size), k
            assert np.abs(got[f"e{i}/" + k]).max() <= \
                (0.5 + 127 * 2.0 ** -23) * scale, k
    weights, _ = R.load_inputs(runs["tiny"])
    params = jax.tree.map(jnp.asarray, weights)
    opt = ropt.AdamW(lr=LR)
    g_port = jax.tree.map(jnp.asarray, R.nest(
        {k[2:]: v for k, v in got.items() if k.startswith("g/")}))
    want, _, gnorm = jax.jit(opt.update)(g_port, opt.init(params), params)
    np.testing.assert_allclose(got["gnorm"][0], float(gnorm), rtol=1e-5)
    for k, v in R.flat(jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(got["p/" + k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"], ref["oracle/loss"],
                               rtol=LOSS_F32)
    specs = param_specs(R.tiny())
    for rank in _shards(runs, "compressed", 4):
        for n, (mine, whole) in rank["ef"].items():
            model = "model" in _axes(specs[n])
            assert mine * 2 * (2 if model else 1) == whole, n
    assert any("model" in _axes(s) for s in specs.values())


# ----------------------------------------- the cases once refused --
def test_tiny_on_four_model_ranks_raises_plan_error(runs):
    """TINY at (1, 4), once refused (its 2 kv heads do not split over 4
    model ranks), now takes the sequence-sharded attention and runs; its
    results against the reference's are
    ``tests/test_torch_seq_parallel.py``'s.  The name is the test's
    first."""
    assert _json(runs, "refusals4")["tiny"] == "ran"
    assert _json(runs, "refusals2")["tiny"] == "ran"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_2_7b"])
def test_ssm_and_hybrid_on_the_model_axis_raise_plan_error(runs, world, arch):
    """The ``ssm`` and ``hybrid`` families at tp 2 and 4, once refused, now
    split their SSD heads over "model" and run; their results against the
    reference's are ``tests/test_torch_ssd_parallel.py``'s.  The name is
    the test's first."""
    assert _json(runs, f"refusals{world}")[arch] == "ran"


# ------------------------------------------------------ checkpoints --
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=_key)
def test_restore_onto_the_model_axis_is_bitexact(runs, mesh):
    seen = _json(runs, f"restore{mesh[0] * mesh[1]}")
    key = _key(mesh)
    assert seen["bitexact"] == {f"{k}/{how}": True for k in seen["shares"]
                                for how in ("restore", "elastic_reshard")}
    specs = R.flat(reference_specs(param_specs(R.port_cfg(RESTORE_ARCH))))
    sizes = {"data": mesh[0], "model": mesh[1]}
    for k, (mine, whole) in seen["shares"][key].items():
        share = int(np.prod([sizes[a] for a in _axes(specs[k])]))
        assert mine * share == whole, (k, specs[k])


def test_save_from_two_model_ranks_is_the_one_rank_save(runs):
    one = CheckpointStore(runs["one"], shard_rows=1 << 10)
    two = CheckpointStore(runs["saved"], shard_rows=1 << 10)
    np.testing.assert_array_equal(two.cvd.checkout(0), one.cvd.checkout(0))
    assert two.manifest["versions"]["0"]["layout"] == \
        one.manifest["versions"]["0"]["layout"]
    seen = _json(runs, "restore1")
    assert seen["back_bitexact"] and seen["bitexact"] == {
        "1x1/restore": True, "1x1/elastic_reshard": True}
