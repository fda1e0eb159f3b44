"""The port's train step across ranks on the CPU (gloo), against the JAX
package's step on meshes of faked host devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``repro.launch.mesh._make_mesh`` (Auto axes).  Both load the same
seeded weights and batches from an ``.npz`` this file writes.

* TINY (``tests/test_elastic_restart.py``'s config), B 4, S 32, two plain
  steps at data 2 and data 4 against the reference's (2, 1) and (4, 1)
  meshes.  In float32 (both packages' ``COMPUTE_DTYPE`` patched) the
  losses and grad norms agree within 1e-5 relative and every parameter
  leaf within 1e-3 relative L2 after the two AdamW steps (the bound and
  its reason are ``tests/test_torch_train.py``'s).  In bf16 the losses and
  grad norms agree within ``launch.serve.prefill_bound`` relative, which is
  above the reference's own spread across meshes (7.5e-5 of the loss).
* OLMoE's SMOKE config (8 experts, top-2, capacity 1.25), B 4, S 64, one
  step at data 2 with 1 and 2 microbatches, float32: loss and grad norm
  within 1e-5 relative of the reference's (2, 1) mesh, and apart from the
  port's data-1 step by more than that (capacity is taken per data shard).
* The compressed step at (pod, data, model) = (2, 1, 1) and (2, 2, 1),
  float32, against the formula oracle: the reference's own
  ``accumulate_grads`` and ``quantize_int8`` on each pod's rows (the
  reference's compressed step does not run on jax 0.9, ROADMAP C.2).  An
  element's ``q`` flips where its ``target / scale`` lies at a rounding
  half-point within the two packages' gradient difference; the residual
  ``e`` agrees within 1e-3 of the pod's scale elsewhere, a flip moves it
  by about one scale, every flip lies within 1e-3 of a half-point, and
  flips are at most 1% of a leaf.  ``ĝ`` agrees within one quantum ``sc /
  npods`` everywhere; ``|e| ≤ s/2`` but for the float32 rounding of
  ``q · s`` (127 · 2^-23 of ``s``); the parameters equal the reference's
  ``AdamW.update`` on the port's ``ĝ`` within 1e-6.
* Each rank holds 1/dp of every leaf whose spec shards it over "data"
  (parameters, AdamW moments), the whole of every other; the eval step
  across ranks equals the one-device eval of the same parameters.
* ``launch.train`` on two ranks, preempted and resumed, against the
  one-rank driver.
"""
import dataclasses
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
from repro_torch import configs as TC
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import from_reference
from repro_torch.train import AdamW, make_train_step

ROOT = Path(__file__).resolve().parents[1]
LOSS_F32 = 1e-5
STEPS_F32 = 1e-3
LR = 1e-3
REF_SPREAD = 7.5e-5     # the reference's bf16 loss across (1,1)/(2,1)/(4,1)
E_TOL = 1e-3            # residual agreement, in units of the pod's scale
HALF_POINT = 1e-3       # a flip's distance from a rounding half-point
FLIP_SHARE = 0.01
REFERENCE_TIMEOUT_S = 240
LAUNCHER = ["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "4", "--seq", "64", "--ckpt-every",
            "2"]


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    tiny = _inputs(tmp / "tiny.npz", _ref_tiny(), 1, 4, 32, 2)
    olmoe = _inputs(tmp / "olmoe.npz", RC.smoke("olmoe_1b_7b"), 2, 4, 64, 1)
    ref_cases = {}
    for data in (2, 4):
        for f32 in (True, False):
            ref_cases[f"tiny_d{data}_{'f32' if f32 else 'bf16'}"] = dict(
                arch="tiny", inputs=tiny, data=data, f32=f32, lr=LR, steps=2)
    for mb in (1, 2):
        ref_cases[f"olmoe_d2_mb{mb}"] = dict(
            arch="olmoe_1b_7b", inputs=olmoe, data=2, f32=True, lr=LR,
            steps=1, microbatches=mb)
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
    try:
        port = {}
        for world in (2, 4):
            cases = []
            for name, spec in ref_cases.items():
                if spec.get("data") == world:
                    port[name] = str(tmp / f"port_{name}")
                    cases.append(("plain", spec, port[name]))
            shape = (2, world // 2, 1)
            name = f"compressed_{'x'.join(map(str, shape))}"
            port[name] = str(tmp / f"port_{name}")
            cases.append(("compressed", dict(arch="tiny", inputs=tiny,
                                             shape=shape, lr=LR), port[name]))
            if world == 2:
                port["launcher"] = str(tmp / "port_launcher")
                cases.append(("launcher", dict(argv=LAUNCHER + [
                    "--ckpt-dir", str(tmp / "ckpt")], preempt=2),
                    port["launcher"]))
            R.spawn(R.run_cases, world, tmp, cases)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK 4" in out, err[-3000:]
    return {"tmp": tmp, "tiny": tiny, "olmoe": olmoe, "port": port,
            "ref": dict(np.load(tmp / "reference.npz"))}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _port(runs, name):
    return dict(np.load(runs["port"][name] + ".npz"))


@pytest.mark.parametrize("data", [2, 4])
def test_tiny_plain_step_matches_reference_f32(runs, data):
    name = f"tiny_d{data}_f32"
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


@pytest.mark.parametrize("data", [2, 4])
def test_tiny_plain_step_matches_reference_bf16(runs, data):
    name = f"tiny_d{data}_bf16"
    bound = prefill_bound(R.tiny())
    assert bound >= REF_SPREAD
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=bound)


@pytest.mark.parametrize("data", [2, 4])
def test_eval_step_across_ranks_is_the_one_rank_eval(runs, data,
                                                     monkeypatch):
    """``make_eval_step(cfg, ctx)`` on the trained FSDP parameters: each
    rank's rows, the loss averaged over the data axis, equal to the
    one-device eval of the same (gathered) parameters within 1e-5."""
    from repro_torch.models import layers as TL
    from repro_torch.train import make_eval_step
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    got = _port(runs, f"tiny_d{data}_f32")
    model = from_reference(R.tiny(), R.nest(
        {k[2:]: v for k, v in got.items() if k.startswith("p/")}),
        device="cpu")
    batch = R.load_inputs(runs["tiny"])[1][0]
    want = float(make_eval_step(R.tiny())(model, batch))
    np.testing.assert_allclose(got["eval"][0], want, rtol=LOSS_F32)


def _one_rank_step(cfg, path, lr):
    weights, batches = R.load_inputs(path)
    model = from_reference(cfg, weights, device="cpu").requires_grad_(True)
    opt = AdamW(lr=lr)
    _, _, m = make_train_step(cfg, opt)(model, opt.init(model), batches[0])
    return float(m["loss"]), float(m["grad_norm"])


@pytest.mark.parametrize("mb", [1, 2])
def test_olmoe_data2_matches_reference_and_differs_from_data1(runs, mb,
                                                              monkeypatch):
    from repro_torch.models import layers as TL
    name = f"olmoe_d2_mb{mb}"
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(TC.smoke("olmoe_1b_7b"), microbatches=mb)
    loss1, norm1 = _one_rank_step(cfg, runs["olmoe"], LR)
    assert abs(loss1 - got["loss"][0]) > LOSS_F32 * abs(loss1)
    assert abs(norm1 - got["gnorm"][0]) > LOSS_F32 * abs(norm1)


def _oracle(runs, npods):
    """The reference's formula (``train_step.py:144-163``) from zero
    residuals, on the reference subprocess's per-pod ``accumulate_grads``
    and ``quantize_int8``: the int32 sum of the pods' ``q``, the largest
    scale, each pod's residual."""
    ref = runs["ref"]
    pods = []
    for p in range(npods):
        pods.append({key: {k.split("/", 2)[2]: v for k, v in ref.items()
                           if k.startswith(f"oracle/{key}{p}/")}
                     for key in ("target", "q", "scale")})
    ghat, res = {}, []
    for k in pods[0]["q"]:
        s = sum(o["q"][k].astype(np.int32) for o in pods)
        sc = max(o["scale"][k] for o in pods)
        ghat[k] = s.astype(np.float32) * sc / np.float32(npods)
    for o in pods:
        res.append({k: o["target"][k] - o["q"][k].astype(np.float32)
                    * o["scale"][k] for k in o["q"]})
    return pods, ghat, res


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)])
def test_compressed_step_matches_formula_oracle(runs, shape):
    npods = shape[0]
    got = _port(runs, f"compressed_{'x'.join(map(str, shape))}")
    pods, ghat, res = _oracle(runs, npods)
    flips = 0
    for k in ghat:
        sc = max(p["scale"][k] for p in pods)
        # ĝ within one quantum sc / npods everywhere
        assert np.abs(got["g/" + k] - ghat[k]).max() <= sc / npods * 1.001, k
        for i, p in enumerate(pods):
            scale = float(p["scale"][k])
            diff = np.abs(got[f"e{i}/" + k] - res[i][k])
            flip = diff > 0.5 * scale
            assert diff[~flip].max(initial=0) <= E_TOL * scale, k
            x = p["target"][k][flip] / scale
            assert np.all(np.abs(np.abs(x - np.floor(x)) - 0.5)
                          <= HALF_POINT), k
            assert flip.sum() <= max(1, FLIP_SHARE * flip.size), k
            # |e| ≤ s/2: the residual is the rounding's remainder (but
            # for q·s's rounding in float32, q up to 127)
            assert np.abs(got[f"e{i}/" + k]).max() <= \
                (0.5 + 127 * 2.0 ** -23) * scale, k
            flips += int(flip.sum())
    # the parameters are the reference's AdamW on the port's ĝ
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
    # the loss is taken before compression: the pods' mean
    np.testing.assert_allclose(got["loss"], runs["ref"]["oracle/loss"],
                               rtol=LOSS_F32)
    print(f"compressed {shape}: {flips} flips")


def _shards(runs, name, world):
    return [json.loads(Path(f"{runs['port'][name]}.shards{r}.json")
                       .read_text()) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_share_of_data_sharded_leaves(runs, world):
    for rank in _shards(runs, f"tiny_d{world}_f32", world):
        sharded = 0
        for key in ("params", "m"):
            for n, (mine, whole) in rank[key].items():
                spec = rank["specs"][n]
                if any(e == "data" or (isinstance(e, list) and "data" in e)
                       for e in spec):
                    assert mine * world == whole, (key, n, spec)
                    sharded += 1
                else:
                    assert mine == whole, (key, n, spec)
        assert sharded > 0
    name = f"compressed_2x{world // 2}x1"
    for rank in _shards(runs, name, world):
        for n, (mine, whole) in rank["ef"].items():
            assert mine * 2 <= whole, n       # at most its pod's row


def test_launcher_on_two_ranks_resumes_and_follows_one_rank(runs, tmp_path,
                                                            capsys):
    """``launch.train`` on two ranks, preempted after 2 steps and resumed
    from its checkpoint, against the one-rank driver's uninterrupted run:
    the same steps, the losses within ``prefill_bound`` (bf16: the ranks
    sum the gradient in another order)."""
    from repro_torch.launch import train as T
    first, second = json.loads(Path(runs["port"]["launcher"] + ".json")
                               .read_text())
    assert first["ranks"] == second["ranks"] == 2
    assert (first["start"], second["start"]) == (0, 2)
    assert first["checkpoints"] == [0] and second["checkpoints"] == [1]
    assert T.main(LAUNCHER + ["--ckpt-dir", str(tmp_path / "one"),
                              "--ckpt-every", "0"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["ranks"] == 1
    bound = prefill_bound(T.reduced_config(TC.get("internlm2_1_8b")))
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               one["losses"], rtol=bound)
