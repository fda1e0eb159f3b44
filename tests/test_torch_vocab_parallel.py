"""The reference's activation layout on the mesh's model axis: the
vocabulary over "model" (the embedding's rows, the LM head's columns, the
cross-entropy over the logits' shards) and the residual stream's sequence
over "model" between blocks, across gloo ranks on the CPU, against the
one-device computation and against the JAX package's steps on meshes of
faked host devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
Both load the same seeded weights and batches from an ``.npz`` this file
writes.  The card holds one NCCL rank, so the numerics across model ranks
are held here.

* The vocabulary at tp 2 and 4, float32, a tied and an untied head, on a
  whole residual and on the sequence-sharded one, with a dense and a
  ``vlm`` loss: the embedding, the final norm and head and ``loss_fn``'s
  cross-entropy against the one-device computation (tokens and labels on
  every rank's first and last rows of a padded vocabulary of 1024 for
  700 tokens): the loss, the rank's logits, the embedding's, head's and
  norm's gradients and the serving head's gathered logits within
  ``COLLECTIVE_TOL`` relative L2.  ``all_gather_seq`` and
  ``reduce_scatter_seq``, forward and gradient, the same.
* Whole steps against the reference's runs on the same meshes, float32:
  InternLM2 SMOKE (tied, 2 kv heads: the rows' sequence attention at
  (1,4)) at (1,2), (2,2) and (1,4), DeepSeek-V2-Lite SMOKE at (1,4),
  Seamless-M4T and LLaVA-NeXT SMOKE at (1,2), and Seamless with 2 kv
  heads at (1,4) (its cross-attention's heads whole: K and V projected
  from the encoder's rows): loss and grad norm within 1e-5 relative,
  every parameter within 1e-3 relative L2 (the bounds of
  ``tests/test_torch_tensor_parallel.py``); but for DeepSeek's (whose
  MoE routes each model rank's slice at its own capacity), the eval
  step on the mesh equals the one-device eval of the same parameters
  within 1e-5.
  (TINY, OLMoE, DeepSeek at (1,2) and (2,2), the ``ssm`` and ``hybrid``
  configs and LLaVA at (1,4) are held by the files of the earlier
  slices.)
* On ``meta`` under the 256-rank counting group (``launch.mesh``), a
  train step with remat at a model axis of 16: no op makes a tensor with
  the padded vocabulary's columns or the whole embedding, and every block
  input remat saves is (rows, S/16, d).
"""
import dataclasses
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
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import counting_group
from repro_torch.models import from_reference
from repro_torch.models import transformer as T
from repro_torch.sharding import make_ctx

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TOL = 1e-6
LOSS_F32 = 1e-5
STEPS_F32 = 1e-3
LR = 1e-3
REFERENCE_TIMEOUT_S = 300
STEPS = [("internlm2_1_8b", (1, 2), None), ("internlm2_1_8b", (2, 2), None),
         ("internlm2_1_8b", (1, 4), None),
         ("deepseek_v2_lite_16b", (1, 4), None),
         ("seamless_m4t_medium", (1, 2), None),
         ("llava_next_34b", (1, 2), None),
         ("seamless_m4t_medium", (1, 4), {"n_kv": 2})]


def _name(arch, mesh, overrides) -> str:
    extra = "".join(f"_{k}{v}" for k, v in (overrides or {}).items())
    return f"{arch}{extra}_{mesh[0]}x{mesh[1]}"


def _inputs(path, arch, overrides, seed, b, s):
    rcfg = dataclasses.replace(RC.smoke(arch), **(overrides or {}))
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    toks = rng.integers(0, rcfg.vocab, (b, s + 1)).astype(np.int32)
    arrays["tokens0"], arrays["labels0"] = toks[:, :-1], toks[:, 1:]
    if rcfg.family == "vlm":
        arrays["patch_embeds0"] = rng.standard_normal(
            (b, rcfg.n_patches, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "encdec":
        arrays["enc_embeds0"] = rng.standard_normal(
            (b, s, rcfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab")
    ref_cases = {}
    for i, (arch, mesh, over) in enumerate(STEPS):
        name = _name(arch, mesh, over)
        inputs = _inputs(tmp / f"{name}.npz", arch, over, 20 + i, 4, 32)
        ref_cases[name] = dict(arch=arch, inputs=inputs, data=mesh[0],
                               model=mesh[1], f32=True, lr=LR, steps=1,
                               overrides=over or {})
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
            port[f"vocab{world}"] = str(tmp / f"vocab{world}")
            cases = [("vocab", dict(seed=world), port[f"vocab{world}"])]
            for name, spec in ref_cases.items():
                mesh = (spec["data"], spec["model"])
                if mesh[0] * mesh[1] == world:
                    port[name] = str(tmp / f"port_{name}")
                    cases.append(("plain", dict(spec, mesh=mesh),
                                  port[name]))
            R.spawn(R.run_cases, world, tmp / f"w{world}", cases)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK 4" in out, err[-3000:]
    return {"port": port, "cases": ref_cases,
            "ref": dict(np.load(tmp / "reference.npz"))}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _json(runs, name):
    return json.loads(Path(runs["port"][name] + ".json").read_text())


# ------------------------------------------------------- the vocabulary --
@pytest.mark.parametrize("layout", ["whole", "rows"])
@pytest.mark.parametrize("head", ["tied", "untied"])
@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_matches_the_one_device_computation(runs, world,
                                                           head, layout):
    errs = {k: v for k, v in _json(runs, f"vocab{world}").items()
            if k.startswith(f"{head}_{layout}_")}
    parts = {"loss", "logits", "last", "dembed", "dscale"} | (
        {"dhead"} if head == "untied" else set())
    for family in ("dense", "vlm"):
        for part in parts:
            assert errs[f"{head}_{layout}_{family}_{part}"] \
                <= COLLECTIVE_TOL, (family, part, errs)
        assert errs[f"{head}_{layout}_{family}_logits_cols"] == 0.0


@pytest.mark.parametrize("kind", ["gather", "scatter"])
@pytest.mark.parametrize("world", [2, 4])
def test_sequence_collectives_match_the_whole_computation(runs, world, kind):
    errs = _json(runs, f"vocab{world}")
    for part in ("fwd", "dx"):
        assert errs[f"seq_{kind}_{part}"] <= COLLECTIVE_TOL, errs


# ------------------------------------------------------------ the steps --
@pytest.mark.parametrize("arch,mesh,overrides", STEPS,
                         ids=[_name(*c) for c in STEPS])
def test_step_matches_reference_f32(runs, arch, mesh, overrides):
    name = _name(arch, mesh, overrides)
    got = dict(np.load(runs["port"][name] + ".npz"))
    ref = runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


# MoE results depend on the model axis (each rank routes its S/m slice at
# its own capacity), so the eval is held to the one-device eval elsewhere
DENSE_STEPS = [c for c in STEPS if c[0] != "deepseek_v2_lite_16b"]


@pytest.mark.parametrize("arch,mesh,overrides", DENSE_STEPS,
                         ids=[_name(*c) for c in DENSE_STEPS])
def test_eval_step_on_the_model_axis_is_the_one_device_eval(
        runs, arch, mesh, overrides, monkeypatch):
    from repro_torch.models import layers as TL
    from repro_torch.train import make_eval_step
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    name = _name(arch, mesh, overrides)
    cfg = R.port_cfg(arch, overrides=overrides)
    got = dict(np.load(runs["port"][name] + ".npz"))
    model = from_reference(cfg, R.nest(
        {k[2:]: v for k, v in got.items() if k.startswith("p/")}),
        device="cpu")
    batch = R.load_inputs(runs["cases"][name]["inputs"])[1][0]
    want = float(make_eval_step(cfg)(model, batch))
    np.testing.assert_allclose(got["eval"][0], want, rtol=LOSS_F32)


# --------------------------------------------------------------- on meta --
M_AXIS = 16


def wide(arch):
    """``arch``'s SMOKE config with its widths raised to divide 16 (as
    ``tests/test_torch_production_mesh.py`` raises them): the SSD's
    d_model 128, the experts 16."""
    cfg = configs.smoke(arch)
    kw = {}
    if cfg.ssd is not None:
        kw.update(d_model=128, ssd=dataclasses.replace(cfg.ssd, d_model=128))
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=16)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_v2_lite_16b",
                                  "zamba2_2_7b", "seamless_m4t_medium"])
def test_no_rank_holds_the_vocabulary_and_remat_saves_rows(arch,
                                                           monkeypatch):
    """Rank 0's train step of ``arch``'s SMOKE config (widths raised to
    divide 16, a vocabulary padded to 3072 that no other dim equals, remat
    on) on the 256-rank counting group: every op's result (a DTensor's
    local shard) has no dim of 3072, and each block input that remat's
    ``checkpoint`` saves is (2, 64/16, d) (2 of the 32 rows a data rank,
    64 positions over 16 model ranks)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    b, s = 32, 64
    monkeypatch.setitem(configs.SHAPES, "wide_train",
                        {"seq": s, "batch": b, "kind": "train"})
    cfg = dataclasses.replace(wide(arch), vocab=3000, remat=True)
    assert cfg.vocab_padded == 3072
    saved, shapes = [], set()
    real = T.checkpoint

    def recording(fn, x, **kw):
        saved.append(tuple(x.shape))
        return real(fn, x, **kw)
    monkeypatch.setattr(T, "checkpoint", recording)

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    t = getattr(t, "_local_tensor", t)
                    shapes.add(tuple(t.shape))
            return out

    with counting_group("single") as mesh:
        ctx = make_ctx(mesh)
        _, step, args = dryrun.cell_step(cfg, "wide_train",
                                         dryrun.rank_model(cfg, mesh), ctx)
        with Shapes():
            step(*args)
    vp, d = cfg.vocab_padded, cfg.d_model
    assert not [sh for sh in shapes if sh[-1:] == (vp,)
                or sh[:1] == (vp,) and sh[-1:] == (d,)]
    assert any(sh[-1:] == (vp // M_AXIS,) for sh in shapes)
    n_blocks = (cfg.n_layers + cfg.n_enc_layers
                + (cfg.n_layers // cfg.shared_every
                   if cfg.family == "hybrid" else 0))
    assert len(saved) == n_blocks * max(cfg.microbatches, 1)
    assert set(saved) == {(b // 16 // max(cfg.microbatches, 1),
                           s // M_AXIS, cfg.d_model)}
