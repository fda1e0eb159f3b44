"""The port's sequence-sharded attention on the mesh's model axis, across
gloo ranks on the CPU, against the whole computation and against the JAX
package's steps on meshes of faked host devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
Both load the same seeded weights and batches from an ``.npz`` this file
writes.  The card holds one NCCL rank, so the numerics across model ranks
are held here (``chip_smoke.py`` phase 26 holds each rank's part on the
card).

* ``layers.seq_attention`` with 3 kv heads on a model axis of 2 and of 4
  (so the reference's ``_sdpa_seq_sharded`` applies) at tp 2 and 4,
  float32, causal and not, each rank its sequence rows of q, k and v: the
  output's rows and the q, k and v gradients' rows, gathered, equal the
  one-device computation within ``COLLECTIVE_TOL`` relative L2 (float32
  sums in another order; a dK/dV whose partial sums were not
  reduce-scattered is off by the other ranks' rows), with two
  ``all_gather_seq`` calls (K and V) forward and their two
  reduce-scatters backward.  The decode merge
  (``merged_decode`` on each rank's slice of a cache) equals the whole
  materialised decode.
* TINY (``tests/test_elastic_restart.py``'s config, 2 kv heads), B 4, S
  32, one plain step at (data, model) = (1, 4), which takes the
  sequence-sharded attention, against the reference's run on the same
  mesh: in float32 the loss and grad norm within 1e-5 relative and every
  parameter within 1e-3 relative L2 after the AdamW step (the bound of
  ``tests/test_torch_tensor_parallel.py``); in bf16 the loss and grad norm
  within ``launch.serve.prefill_bound``.
* LLaVA-NeXT's SMOKE config (``vlm``, 2 kv heads, patch embeddings), one
  float32 step at (1, 4) against the reference's, held as TINY's.
* Attention weights that stay the rank's "model" shards where the kv
  heads do not split, gathered whole at each use
  (``layers.at_use``), held as TINY's, float32: Mistral-NeMo's SMOKE
  config (1 kv head) at (1, 2), (2, 2) and (1, 4) on the
  sequence-sharded residual (each weight's gradient a partial sum over
  the rank's rows, reduce-scattered to its shard), at (1, 4) on S 30,
  which the axis does not divide (the whole residual: every rank the
  same whole gradient, sliced), and Qwen1.5's (q/k/v biases, whole) with
  2 kv heads at (1, 4); each step gathered weights at use
  (``sharding.TP_CALLS["gather_weight"]``).
* Where the sequence-sharded path is taken (``layers.seq_sharded``: the
  reference's rule) and the working copy's attention weights
  (``train_step.working_specs``): every rank its "model" shard of
  ``wq``/``wk``/``wv``/``wo`` whether or not the heads split.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_ranks as R
from repro import configs as RC
from repro.models import transformer as RT
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import layers as L
from repro_torch.sharding import mesh_context
from repro_torch.train.train_step import working_specs

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TOL = 1e-6
LOSS_F32 = 1e-5
STEPS_F32 = 1e-3
LR = 1e-3
REFERENCE_TIMEOUT_S = 300
MESH = (1, 4)


def _ref_tiny():
    return RT.ArchConfig(name="tiny-ft", family="dense", n_layers=2,
                         d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                         head_dim=16, tie_embeddings=True, remat=False,
                         microbatches=1)


# the plain steps where the kv heads do not split (beyond TINY's and
# LLaVA's at (1, 4)): name -> (arch, mesh, overrides, seq)
WHOLE_HEADS = {
    "mistral_1x2": ("mistral_nemo_12b", (1, 2), {}, 32),
    "mistral_2x2": ("mistral_nemo_12b", (2, 2), {}, 32),
    "mistral_1x4": ("mistral_nemo_12b", (1, 4), {}, 32),
    "mistral_1x4_s30": ("mistral_nemo_12b", (1, 4), {}, 30),
    "qwen_kv2_1x4": ("qwen15_4b", (1, 4), {"n_kv": 2}, 32)}


def _inputs(path, rcfg, seed, b, s):
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    toks = rng.integers(0, rcfg.vocab, (b, s + 1)).astype(np.int32)
    arrays["tokens0"], arrays["labels0"] = toks[:, :-1], toks[:, 1:]
    if rcfg.family == "vlm":
        arrays["patch_embeds0"] = rng.standard_normal(
            (b, rcfg.n_patches, rcfg.d_model)).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    inputs = {"tiny": _inputs(tmp / "tiny.npz", _ref_tiny(), 0, 4, 32),
              "llava_next_34b": _inputs(tmp / "llava.npz",
                                        RC.smoke("llava_next_34b"), 1, 4, 32)}
    ref_cases = {
        "tiny_f32": dict(arch="tiny", f32=True),
        "tiny_bf16": dict(arch="tiny", f32=False),
        "llava_f32": dict(arch="llava_next_34b", f32=True)}
    for spec in ref_cases.values():
        spec.update(inputs=inputs[spec["arch"]], data=MESH[0],
                    model=MESH[1], lr=LR, steps=1)
    for i, (name, (arch, mesh, over, seq)) in enumerate(WHOLE_HEADS.items()):
        rcfg = dataclasses.replace(RC.smoke(arch), **over)
        ref_cases[name] = dict(
            arch=arch, f32=True, overrides=over, data=mesh[0],
            model=mesh[1], lr=LR, steps=1,
            inputs=_inputs(tmp / f"{name}.npz", rcfg, 10 + i, 4, seq))
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
            port[f"seq{world}"] = str(tmp / f"seq{world}")
            cases.append(("seq_attention", dict(seed=world),
                          port[f"seq{world}"]))
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
    return {"port": port, "ref": dict(np.load(tmp / "reference.npz"))}


def _json(runs, name):
    return json.loads(Path(runs["port"][name] + ".json").read_text())


def _port(runs, name):
    return dict(np.load(runs["port"][name] + ".npz"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# --------------------------------------------- the attention itself --
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", ["causal", "full"])
def test_seq_sharded_attention_matches_the_whole_computation(runs, world,
                                                             tag):
    errs = _json(runs, f"seq{world}")
    assert errs[f"{tag}_taken"] == 0.0
    for part in ("fwd", "dq", "dk", "dv"):
        assert errs[f"{tag}_{part}"] <= COLLECTIVE_TOL, (part, errs)
    calls = errs[f"{tag}_calls"]
    assert (calls["all_gather_seq"], calls["reduce_scatter_seq"],
            calls["copy_to_tp"]) == (4, 0, 0), calls


@pytest.mark.parametrize("world", [2, 4])
def test_decode_merge_matches_the_whole_decode(runs, world):
    assert _json(runs, f"seq{world}")["decode_fwd"] <= COLLECTIVE_TOL


# ------------------------------------------------------ the steps --
@pytest.mark.parametrize("name", ["tiny_f32", "llava_f32"])
def test_step_on_four_model_ranks_matches_reference_f32(runs, name):
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k


@pytest.mark.parametrize("name", list(WHOLE_HEADS))
def test_step_where_the_kv_heads_do_not_split_matches_reference_f32(runs,
                                                                    name):
    got, ref = _port(runs, name), runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=LOSS_F32)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= STEPS_F32, k
    calls = json.loads(Path(runs["port"][name] + ".shards0.json")
                       .read_text())["calls"]
    assert calls["gather_weight"] > 0, calls


def test_tiny_on_four_model_ranks_matches_reference_bf16(runs):
    got, ref = _port(runs, "tiny_bf16"), runs["ref"]
    bound = prefill_bound(R.tiny())
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"tiny_bf16/{key}"],
                                   rtol=bound)
        assert np.isfinite(got[key]).all()


# --------------------------------------------------- where it is taken --
def _ctx(m: int):
    """A stand-in mesh context with a model axis of ``m`` (what
    ``sharding.tp_group`` reads), no group behind it."""
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           get_local_rank=lambda axis: 0)
    return SimpleNamespace(mesh=mesh, tp="model", tp_size=m,
                           group=lambda axis: None)


@pytest.mark.parametrize("sq,sk,n_kv,m,taken", [
    (32, 32, 2, 4, True),       # TINY at (1, 4)
    (4096, 4096, 8, 16, True),  # LLaVA-NeXT-34B at a model axis of 16
    (32, 32, 2, 2, False),      # the kv heads divide the axis
    (30, 30, 2, 4, False),      # the sequence does not: replicated heads
    (1, 64, 2, 4, False),       # a decode step
    (32, 64, 2, 4, False),      # fewer queries than keys
    (32, 32, 2, 1, False),      # a model axis of 1
])
def test_seq_sharded_where_the_reference_takes_it(sq, sk, n_kv, m, taken):
    with mesh_context(_ctx(m)):
        assert L.seq_sharded(sq, sk, n_kv) is taken
    assert L.seq_sharded(sq, sk, n_kv) is False         # no context


@pytest.mark.parametrize("m,split", [(1, True), (2, True), (4, False)])
def test_attention_weights_stay_model_shards_where_the_heads_do_not_split(
        m, split):
    """TINY's 2 kv heads split a model axis of 1 and 2, not 4; either way
    the working copy holds each rank's columns of ``wq``/``wk``/``wv`` and
    rows of ``wo`` (whole heads gather them at use)."""
    cfg = R.tiny()
    assert L.heads_split(cfg.n_kv, m) is split
    specs = working_specs(cfg, m)
    attn = [n for n in specs if ".attn." in n]
    assert attn
    for n in attn:
        want = ("model", None) if ".wo." in n else (None, "model")
        assert specs[n] == want, (n, specs[n])
