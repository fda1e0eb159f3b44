"""The port's SSD heads over the mesh's model axis, across gloo ranks on the
CPU, against the one-device layer and against the JAX package's steps on
meshes of faked host devices.

Ranks are spawned processes in a gloo group joined through a ``file://``
store (``tests/torch_ranks.py``); the reference runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
Both load the same seeded weights and batches from an ``.npz`` this file
writes.  The card holds one NCCL rank, so the numerics across model ranks
are held here (``chip_smoke.py`` phase 26 holds each rank's heads on the
card).

* An SSD layer (Mamba2 SMOKE's geometry, float32) at tp 2 and 4, each rank
  its heads' working columns (``models.ssd.head_columns``), against the
  layer on one device: the forward, the final state's heads, dx and the
  gradient of every leaf (the norm, ``in_proj`` and ``conv_w`` among them;
  B and C whole on every rank) within ``COLLECTIVE_TOL`` relative L2, and
  one decode step (y, the rank's heads of ``h`` exactly, the whole conv
  state exactly).
* Mamba2 and Zamba2 SMOKE (``ssm`` and ``hybrid``), B 4, S 64, one plain
  step at (data, model) = (1,2), (2,2) and (1,4) against the reference's
  run on the same mesh: in float32 (both packages' ``COMPUTE_DTYPE``
  patched) the loss, the grad norm and every parameter after the AdamW
  step within ``F32_RTOL`` = 1e-5 relative; in bf16 the loss and grad
  norm within ``launch.serve.prefill_bound``, which is above the
  reference's own bf16 spread across these meshes (2.2e-4 of the loss,
  ``BF16_SPREAD``; ROADMAP §A lists the reference's runs).
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
from repro_torch.launch.serve import prefill_bound

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TOL = 1e-6
F32_RTOL = 1e-5
BF16_SPREAD = 2.2e-4
LR = 1e-3
REFERENCE_TIMEOUT_S = 300
ARCHS = ("mamba2_780m", "zamba2_2_7b")
MESHES = [(1, 2), (2, 2), (1, 4)]


def _key(mesh) -> str:
    return "x".join(map(str, mesh))


def _inputs(path, arch, seed, b, s):
    rcfg = RC.smoke(arch)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    arrays = {"w/" + k: v for k, v in R.flat(tree).items()}
    toks = rng.integers(0, rcfg.vocab, (b, s + 1)).astype(np.int32)
    arrays["tokens0"], arrays["labels0"] = toks[:, :-1], toks[:, 1:]
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssdp")
    inputs = {a: _inputs(tmp / f"{a}.npz", a, i, 4, 64)
              for i, a in enumerate(ARCHS)}
    ref_cases = {}
    for arch in ARCHS:
        for mesh in MESHES:
            for f32 in (True, False):
                ref_cases[f"{arch}_{_key(mesh)}_{'f32' if f32 else 'bf16'}"] \
                    = dict(arch=arch, inputs=inputs[arch], data=mesh[0],
                           model=mesh[1], f32=f32, lr=LR, steps=1)
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
            port[f"layer{world}"] = str(tmp / f"layer{world}")
            cases = [("ssd_layer", dict(seed=world, arch="mamba2_780m"),
                      port[f"layer{world}"])]
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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("part", ["forward", "gradients", "decode"])
def test_ssd_heads_match_the_one_device_layer(runs, world, part):
    errs = json.loads(Path(runs["port"][f"layer{world}"] + ".json")
                      .read_text())
    keys = {"forward": ["fwd", "state"],
            "gradients": ["dx", "dnorm", "din_proj.w", "dconv_w", "dconv_b",
                          "dA_log", "dD", "ddt_bias", "dout_proj.w"],
            "decode": ["decode_y", "decode_h", "decode_conv"]}[part]
    for k in keys:
        assert errs[k] <= COLLECTIVE_TOL, (k, errs[k])
    if part == "decode":            # each rank's heads; conv gathered whole
        assert errs["decode_h"] == 0.0 and errs["decode_conv"] == 0.0
    if part == "forward":           # the heads are independent
        assert errs["state"] == 0.0


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_step_on_the_model_axis_matches_reference_f32(runs, arch, mesh):
    name = f"{arch}_{_key(mesh)}_f32"
    got = dict(np.load(runs["port"][name] + ".npz"))
    ref = runs["ref"]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=F32_RTOL)
    leaves = [k for k in got if k.startswith("p/")]
    assert len(leaves) == len([k for k in ref
                               if k.startswith(f"{name}/p/")])
    for k in leaves:
        assert _rel(got[k], ref[f"{name}/{k}"]) <= F32_RTOL, k


@pytest.mark.parametrize("mesh", MESHES, ids=_key)
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_step_on_the_model_axis_matches_reference_bf16(runs, arch, mesh):
    name = f"{arch}_{_key(mesh)}_bf16"
    bound = prefill_bound(R.port_cfg(arch))
    assert bound >= BF16_SPREAD
    got, ref = dict(np.load(runs["port"][name] + ".npz")), runs["ref"]
    for key in ("loss", "gnorm"):
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], ref[f"{name}/{key}"],
                                   rtol=bound)
