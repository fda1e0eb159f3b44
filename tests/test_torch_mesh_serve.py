"""Serving on a (data, model) mesh: the port's ``make_prefill_step`` and
``make_serve_step`` under a mesh context, across gloo ranks on the CPU,
against the JAX package's steps on meshes of faked host devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
Both load the same seeded weights, prompts and cache from an ``.npz``
this file writes: B 4 prompts of S 64 tokens, and a cache of
``MAX_LEN`` 16 positions filled with seeded values, ``len`` 5 (so the
decode's positions fall on several model ranks), laid out by
``cache_specs`` on both sides.  Float32 (both packages' ``COMPUTE_DTYPE``
patched).  The card holds one NCCL rank, so the numerics across model
ranks are held here.

* InternLM2 (2 kv heads: the sequence-sharded prefill at (1,4)), Mamba2,
  Zamba2, OLMoE and DeepSeek-V2-Lite SMOKE at (data, model) = (1,2), (2,2)
  and (1,4), and the two stub-frontend families, Seamless-M4T-medium
  (its encoder K/V in the cache, the decode's cross-attention merged
  over "model" too) and LLaVA-NeXT (2 kv heads), with seeded frame or
  patch embeddings: each rank's rows of the prefill's logits and of 4 greedy
  decode steps' logits within ``SERVE_F32`` = 1e-5 relative L2 of the
  reference's (float32 sums in other orders), the greedy tokens equal
  (the serve steps' and ``greedy_decode``'s), and each rank's cache after
  the steps within ``SERVE_F32`` of its part of the reference's.
* Each rank holds 1/m of the cache's sequence and of ``h``'s heads, its
  rows of the batch, and the whole conv state, which is equal on every
  model rank after each step; ``init_cache(..., ctx=)`` gives the same
  shapes, and a cache whose sequence does not divide the model axis
  raises ``PlanError`` (the reference's ``device_put`` refuses it).
* The model group's collectives on the decode, by kind (the first five).
* ``cache_specs`` equals the reference's, spec for spec, for every config
  at B 1 and B 4.
* The serve launcher's production meshes (``--mesh single|multi``) refuse
  a group of the wrong size and serve on one of theirs (patched to one
  rank here; ``tests/test_torch_production_mesh.py`` runs four).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_ranks as R
from repro import configs as RC
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
SERVE_F32 = 1e-5
REFERENCE_TIMEOUT_S = 300
COUNTED = ("internlm2_1_8b", "mamba2_780m", "zamba2_2_7b", "olmoe_1b_7b",
           "deepseek_v2_lite_16b")
ARCHS = COUNTED + ("seamless_m4t_medium", "llava_next_34b")
MESHES = [(1, 2), (2, 2), (1, 4)]
B, S, MAX_LEN, FILL, STEPS = 4, 64, 16, 5, 4


def _key(mesh) -> str:
    return "x".join(map(str, mesh))


def _inputs(path, arch, seed):
    rcfg = RC.smoke(arch)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    arrays["prompt"] = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    if rcfg.family == "encdec":
        arrays["enc_embeds"] = rng.standard_normal(
            (B, S, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "vlm":
        arrays["patch_embeds"] = rng.standard_normal(
            (B, rcfg.n_patches, rcfg.d_model)).astype(np.float32)
    for name, leaf in TT.init_cache_abstract(R.port_cfg(arch), B,
                                             MAX_LEN).items():
        if name == "len":
            arrays["cache/len"] = np.asarray(FILL, np.int32)
        else:
            scale = 0.5 if name in ("h", "conv") else 1.0
            arrays["cache/" + name] = (scale * rng.standard_normal(
                tuple(leaf.shape))).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    inputs = {a: _inputs(tmp / f"{a}.npz", a, i) for i, a in enumerate(ARCHS)}
    ref_cases = {f"{a}_{_key(m)}": dict(kind="serve", arch=a,
                                         inputs=inputs[a], data=m[0],
                                         model=m[1], f32=True, steps=STEPS,
                                         max_len=MAX_LEN)
                 for a in ARCHS for m in MESHES}
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
                mesh = (spec["data"], spec["model"])
                if mesh[0] * mesh[1] == world:
                    port[name] = str(tmp / f"port_{name}")
                    cases.append(("serve", dict(spec, mesh=mesh),
                                  port[name]))
            R.spawn(R.run_cases, world, tmp / f"w{world}", cases)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK 4" in out, err[-3000:]
    return {"port": port, "inputs": inputs,
            "ref": dict(np.load(tmp / "reference.npz"))}


def _ranks(runs, name, mesh):
    out = []
    for r in range(mesh[0] * mesh[1]):
        base = f"{runs['port'][name]}.rank{r}"
        out.append((json.loads(Path(base + ".json").read_text()),
                    dict(np.load(base + ".npz"))))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _rows(a, dp_rank: int, dp: int):
    n = a.shape[0] // dp
    return a[dp_rank * n:(dp_rank + 1) * n]


def _part(a, spec, meta, mesh):
    """The part of a whole cache leaf ``a`` (reference layout) a rank with
    ``meta``'s indices holds under ``spec``."""
    sizes = {"data": mesh[0], "model": mesh[1], "pod": 1}
    index = {"data": meta["dp_rank"], "model": meta["tp_rank"], "pod": 0}
    for dim, entry in enumerate(spec):
        axes = [entry] if isinstance(entry, str) else (entry or [])
        n = int(np.prod([sizes[x] for x in axes]))
        r = 0
        for x in axes:
            r = r * sizes[x] + index[x]
        size = a.shape[dim] // n
        a = np.take(a, range(r * size, (r + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serve_matches_reference(runs, arch, mesh):
    name = f"{arch}_{_key(mesh)}"
    ref = {k[len(name) + 1:]: v for k, v in runs["ref"].items()
           if k.startswith(name + "/")}
    for meta, got in _ranks(runs, name, mesh):
        rows = lambda a: _rows(a, meta["dp_rank"], mesh[0])  # noqa: E731
        assert _rel(got["prefill"], rows(ref["prefill"])) <= SERVE_F32
        for i in range(STEPS):
            assert _rel(got[f"logits{i}"], rows(ref[f"logits{i}"])) \
                <= SERVE_F32, i
        np.testing.assert_array_equal(got["tokens"], rows(ref["tokens"]))
        np.testing.assert_array_equal(got["greedy"], got["tokens"])
        for k, v in got.items():
            if k.startswith("cache/"):
                want = _part(ref[k], meta["specs"][k[6:]], meta, mesh)
                assert _rel(v, want) <= SERVE_F32, k
        assert meta["len"] in (-1, FILL + STEPS)


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_part_of_the_cache(runs, arch, mesh):
    name = f"{arch}_{_key(mesh)}"
    cfg = R.port_cfg(arch)
    whole = {k: tuple(t.shape) for k, t in
             TT.init_cache_abstract(cfg, B, MAX_LEN).items() if k != "len"}
    ranks = _ranks(runs, name, mesh)
    dp, m = mesh
    for meta, got in ranks:
        assert meta["fresh"] == meta["shapes"]
        for k, shape in whole.items():
            want = list(shape)
            want[1] //= dp                                 # the batch rows
            if k == "h":
                want[2] //= m                              # the heads
            elif k != "conv":
                want[2] //= m                              # the sequence
            assert meta["shapes"][k] == want, (k, meta["shapes"][k], want)
        kv = any(k not in ("h", "conv") for k in whole)
        uneven = (MAX_LEN + 2) % m != 0 and kv
        assert meta["uneven"].startswith("PlanError") == uneven, \
            meta["uneven"]
    if "conv" in whole:              # every model rank's copy is the same
        for i in range(STEPS):
            for (ma, a), (mb, b) in zip(ranks, ranks[1:]):
                if ma["dp_rank"] == mb["dp_rank"]:
                    np.testing.assert_array_equal(a[f"conv{i}"],
                                                  b[f"conv{i}"])


@pytest.mark.parametrize("arch", COUNTED)
def test_decode_collectives_by_kind(runs, arch):
    """(1, 4): a decode step's model-group collectives, 4 steps: an
    attention layer gathers its heads' q, k and v once (none where its
    heads are whole), merges with one ``decode_max`` and two
    ``decode_sum``; an SSD layer gathers its x row and sums its norm's
    squares; every row-parallel product reduces once."""
    cfg = R.port_cfg(arch)
    meta, _ = _ranks(runs, f"{arch}_1x4", (1, 4))[0]
    calls = meta["calls"]["decode"]
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = (cfg.n_layers // cfg.shared_every if cfg.family == "hybrid"
              else 0 if cfg.family == "ssm" else cfg.n_layers)
    split = (cfg.mla.n_heads if cfg.attn_type == "mla" else cfg.n_kv) % 4 == 0
    mla = cfg.attn_type == "mla"
    # a SwiGLU or an MoE layer's shared expert, each with its own reduce
    mlp = (n_attn if cfg.family != "moe" or cfg.moe.n_shared
           else cfg.first_dense)
    want = {"decode_max": STEPS * n_attn, "decode_sum": 2 * STEPS * n_attn,
            "norm_sum": STEPS * n_ssd,
            "gather_seq": STEPS * (n_ssd + n_attn * (2 if mla else 1)
                                   * split),
            "reduce_from_tp": STEPS * (n_ssd + n_attn * split + mlp)}
    for k, v in want.items():
        assert calls[k] == v, (k, calls)
    assert calls["kv_grad_sum"] == calls["copy_to_tp"] == 0


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, batch):
    port = TT.cache_specs(TC.smoke(arch), batch)
    ref = RT.cache_specs(RC.smoke(arch), batch)
    assert port == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_serve_launcher_refuses_the_production_meshes(mesh, monkeypatch):
    """The production mesh needs its 256 or 512 ranks: on one it raises
    ``PlanError`` and starts no group; with its shape patched to one rank
    the launcher serves on it (the parameters as DTensors, the cache laid
    out by ``cache_specs``, the steps under the mesh context), its prefill
    logits within ``SERVE_F32`` of the one-device serve's in float32."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.build import PlanError
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as TL
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--mesh", mesh, "--reduced", "--device", "cpu", "--requests",
            "2", "--prompt-len", "16", "--decode-steps", "2"]
    ranks = {"single": 256, "multi": 512}[mesh]
    with pytest.raises(PlanError, match=f"needs {ranks} ranks"):
        tserve.main(argv)
    assert not dist.is_initialized()
    shape, names = M.PRODUCTION[mesh]
    monkeypatch.setitem(M.PRODUCTION, mesh, ((1,) * len(shape), names))
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    runs = []
    real = tserve.serve
    monkeypatch.setattr(tserve, "serve",
                        lambda *a, **k: runs.append(real(*a, **k)) or runs[-1])
    assert tserve.main(argv) == 0
    assert not dist.is_initialized()
    cfg = tserve.reduced_config(TC.get("internlm2_1_8b"))
    alone = real(cfg, requests=2, prompt_len=16, decode_steps=2,
                 device="cpu", log=lambda *a: None)
    got, want = runs[0]["prefill_logits"], alone["prefill_logits"]
    assert runs[0]["result"]["mesh"] == dict(zip(names, (1,) * len(names)))
    assert float((got - want).norm() / want.norm()) <= SERVE_F32
