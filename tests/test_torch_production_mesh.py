"""The production meshes: the dry run on the reference's 256-rank (data 16,
model 16) and 512-rank (pod 2, data 16, model 16) meshes, the collectives
in the count, and the launchers' ``--mesh single|multi``.

* ``launch.op_count`` on a ``"fake"`` group of 256 ranks
  (``launch.mesh.counting_group``): each collective counted under the
  reference's kind at its result's bytes; a c10d op of no kind raises; a
  DTensor argument and a DTensor op charged at the local shard.
* Per-rank FLOPs times the ranks equal the one-device count of the same
  prefill plus what the port repeats on every model rank, a closed form
  whose terms each name their ROADMAP C.3 entry, for one SMOKE config of
  each family (widths raised to divide 16) on both meshes.
* The model group's collectives in a train step's count equal
  ``sharding.TP_CALLS`` plus the step's own reduces and gathers over
  "model"; the working copy's all-gathers over "data" are one a leaf
  sharded over it, their bytes its working shards'; the gradient's
  all-reduces over "data" one a leaf.
* The reference's dry run on the SMOKE configs it compiles and three
  full-size cells, in one subprocess that fakes its 512 devices before
  jax starts, beside the port's records of the same cells.
* The launchers on 4 gloo ranks (``tests/torch_ranks.py``) with the
  production shapes patched to (2, 2) and (2, 1, 2); the unpatched meshes
  refused on them; no launcher and no ``start_group`` starts ``"fake"``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks as R
from repro_torch import configs
from repro_torch.kernels.build import PlanError
from repro_torch.launch import dryrun, op_count
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import heads_split
from repro_torch.models.moe import _capacity
from repro_torch.models.transformer import abstract_params, param_specs
from repro_torch.sharding import TP_CALLS, TP_RECOMPUTE, zero_tp_calls
from repro_torch.train.train_step import REGROUPED, working_specs

ROOT = Path(__file__).resolve().parents[1]
B, S = 32, 64                     # divides (pod 2 ×) data 16 and model 16
M_AXIS = 16
DP = {"single": 16, "multi": 32}
FAMILIES = {"dense": "internlm2_1_8b", "moe": "olmoe_1b_7b",
            "mla": "deepseek_v2_lite_16b", "ssm": "mamba2_780m",
            "hybrid": "zamba2_2_7b", "encdec": "seamless_m4t_medium",
            "vlm": "llava_next_34b"}
REFERENCE_TIMEOUT_S = 300      # ≈35 s alone; ≈120 s under six workers
# the SMOKE configs the reference compiles on both meshes (the other four
# have widths that do not divide 16), and three full-size cells
REFERENCE_SMOKE = ("internlm2_1_8b", "qwen15_4b", "mistral_nemo_12b",
                   "phi3_medium_14b", "llava_next_34b", "seamless_m4t_medium")
FULL_CELLS = (("internlm2_1_8b", "decode_32k", "single"),
              ("zamba2_2_7b", "train_4k", "single"),
              ("olmoe_1b_7b", "prefill_32k", "multi"))


def wide(arch):
    """``arch``'s SMOKE config with its widths raised to divide 16: the
    SSD's d_model 128 (16 heads of 16), the experts 16."""
    cfg = configs.smoke(arch)
    kw = {}
    if cfg.ssd is not None:
        kw.update(d_model=128, ssd=dataclasses.replace(cfg.ssd, d_model=128))
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=16)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture
def cells(monkeypatch):
    for kind in ("train", "prefill", "decode"):
        monkeypatch.setitem(configs.SHAPES, f"wide_{kind}",
                            {"seq": S, "batch": B, "kind": kind})


@pytest.fixture
def fake_mesh():
    with M.counting_group("single") as mesh:
        yield mesh
    assert not dist.is_initialized()


# ------------------------------------------------ (a) op_count on 256 ----
def _meta(*shape):
    return torch.empty(shape, device="meta")


COLLECTIVES = {
    # name: (the call on the model group, its kind, result bytes)
    "all_reduce": (lambda g, mesh: dist.all_reduce(_meta(8, 4), group=g),
                   "all-reduce", 8 * 4 * 4),
    "all_gather": (lambda g, mesh: dist.all_gather(
        [_meta(8) for _ in range(16)], _meta(8), group=g),
        "all-gather", 16 * 8 * 4),
    "all_to_all": (lambda g, mesh: dist.all_to_all_single(
        _meta(32), _meta(32), group=g), "all-to-all", 32 * 4),
    "reduce_scatter": (lambda g, mesh: dist.reduce_scatter_tensor(
        _meta(2), _meta(32), group=g), "reduce-scatter", 2 * 4),
    "redistribute": (lambda g, mesh: _sharded(mesh).redistribute(
        mesh, _replicated()), "all-gather", 1024 * 64 * 4),
}


def _replicated():
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def _sharded(mesh):
    """A (1024, 64) float32 DTensor, Shard(0) over "model": 64 rows a
    rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(_meta(64, 64), mesh, (Replicate(), Shard(0)),
                              run_check=False, shape=(1024, 64),
                              stride=(64, 1))


@pytest.mark.filterwarnings("ignore::FutureWarning")
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_counted_by_kind_at_its_result(fake_mesh, name):
    call, kind, nbytes = COLLECTIVES[name]
    g = fake_mesh.get_group("model")
    cost = op_count.analyze(lambda: call(g, fake_mesh))
    assert cost.coll_counts == {k: int(k == kind)
                                for k in op_count.COLLECTIVE_KINDS}
    assert cost.coll_bytes[kind] == nbytes
    assert sum(cost.coll_bytes.values()) == nbytes
    assert cost.coll_groups == {g.group_name: {kind: [1, nbytes]}}
    assert cost.bytes == 0 and cost.flops == 0    # no HBM bytes


def test_an_unmapped_c10d_op_raises(fake_mesh):
    g = fake_mesh.get_group("model")
    with pytest.raises(NotImplementedError, match="none of the reference"):
        op_count.analyze(lambda: dist.barrier(group=g))


def test_dtensors_are_charged_at_the_local_shard(fake_mesh):
    x = _sharded(fake_mesh)
    cost = op_count.analyze(lambda t: t * 2, x)
    local = 64 * 64 * 4
    assert cost.argument_bytes == local
    assert cost.bytes == 2 * local                # read once, written once
    assert cost.temp_bytes == local
    y = _sharded(fake_mesh)
    w = torch.distributed.tensor.DTensor.from_local(
        _meta(64, 32), fake_mesh, _replicated(), run_check=False,
        shape=(64, 32), stride=(32, 1))
    cost = op_count.analyze(torch.mm, y, w)
    assert cost.flops == 2 * 64 * 64 * 32         # the local rows' product


def test_the_counting_group_is_one_at_a_time_and_ends():
    with M.counting_group("multi") as mesh:
        assert mesh.size() == 512 and dist.get_world_size() == 512
        assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")
        with pytest.raises(PlanError, match="process of its own"):
            with M.counting_group("single"):
                pass
    assert not dist.is_initialized()


# ------------------------------------------- (b) FLOPs scale with chips --
def repeated_prefill_flops(cfg, m: int, dp: int) -> int:
    """What the port's prefill of B × S repeats on each of the ``m`` model
    ranks of a (pod, data) line, summed over the ``dp · m`` ranks, beyond
    the one-device count.  Each term names its divergence.  The LM head
    runs on the rank's vocabulary columns, and attention whose kv heads do
    not split projects the rank's sequence rows: neither repeats."""
    d = cfg.d_model
    per = 0
    if cfg.attn_type == "mla":
        a = cfg.mla
        if not heads_split(a.n_heads, m):
            # C.3 Slice 15: latent attention's weights whole where its heads
            # do not split; and C.3 Slice 16: its core on every head and
            # every row on each model rank (q·kᵀ over dq, P·V over v_head)
            h, dq = a.n_heads, a.qk_nope + a.qk_rope
            per += cfg.n_layers * 2 * B * S * (
                d * h * dq + d * (a.kv_lora + a.qk_rope)
                + a.kv_lora * h * (a.qk_nope + a.v_head) + h * a.v_head * d)
            per += cfg.n_layers * 2 * B * h * S * S * (dq + a.v_head)
    if cfg.ssd is not None:
        # C.3 Slice 15: every rank's heads read the whole B and C: their
        # in_proj columns and C·Bᵀ per chunk
        s = cfg.ssd
        per += cfg.n_layers * 2 * B * S * s.d_state * (2 * d + s.chunk)
    out = (m - 1) * per
    if cfg.moe is not None:
        # src/repro/models/moe.py:82-85,134-146: each model rank routes its
        # S/m slice at its own capacity (at least 8 slots an expert)
        e = cfg.moe
        n_moe = cfg.n_layers - cfg.first_dense
        cap = _capacity((B // dp) * S // m, e)
        out += n_moe * 6 * d * e.d_ff_expert * e.n_experts * (
            dp * m * cap - _capacity(B * S, e))
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("family", FAMILIES)
def test_flops_times_ranks_are_the_one_device_count_plus_the_repeats(
        cells, family, mesh):
    cfg = wide(FAMILIES[family])
    one, _, _ = dryrun.count_cell(cfg, "wide_prefill")
    rank0, chips, _ = dryrun.count_cell(cfg, "wide_prefill", mesh)
    assert chips == DP[mesh] * M_AXIS
    assert rank0.flops * chips == one.flops + repeated_prefill_flops(
        cfg, M_AXIS, DP[mesh])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_serve_count_is_the_same_first_in_its_process(cells, kind):
    """The working copy's layout (``working_specs``, cached, built from a
    whole ``meta`` model) is made before the count, so a cell's peak does
    not depend on whether a count in the process made it first."""
    cfg = wide("internlm2_1_8b")
    working_specs.cache_clear()
    first, _, _ = dryrun.count_cell(cfg, f"wide_{kind}", "single")
    again, _, _ = dryrun.count_cell(cfg, f"wide_{kind}", "single")
    assert first.temp_bytes == again.temp_bytes
    assert first.peak_estimate_bytes == again.peak_estimate_bytes


# --------------------------------------------- (c) collectives reckoned --
def _axes_of(spec):
    return tuple(a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e))


@pytest.mark.parametrize("arch,mesh", [("internlm2_1_8b", "single"),
                                       ("olmoe_1b_7b", "multi"),
                                       ("zamba2_2_7b", "single")])
def test_train_collectives_as_reckoned(cells, arch, mesh):
    cfg = wide(arch)
    zero_tp_calls()
    cost, _, axes = dryrun.count_cell(cfg, "wide_train", mesh)
    got = dryrun.by_axis(cost, axes)
    specs = param_specs(cfg)
    work = working_specs(cfg, M_AXIS)
    leaves = dict(abstract_params(cfg).named_parameters())

    def calls(axis, kind):
        return got.get(axis, {}).get(kind, [0, 0])[0]

    # the model group: the layers' collectives (TP_CALLS, remat's
    # recompute apart), the global norm's sum over each set of axes that
    # names "model", and one all-gather a leaf whose working layout and
    # parameter layout differ over "model": the working copy's gather of a
    # leaf it holds whole, the gradient's gather back into a leaf the
    # parameter holds whole; a regrouped SSD leaf is gathered whole (where
    # its parameter is sharded) and its gradient gathered back
    norm_groups = {_axes_of(s) for s in specs.values()}
    regrouped = [n for n, w in work.items() if w == REGROUPED]
    differ = [n for n, w in work.items() if w != REGROUPED
              and ("model" in _axes_of(specs[n]))
              != ("model" in _axes_of(w))]
    model = sum(calls("model", k) for k in op_count.COLLECTIVE_KINDS)
    assert model == (sum(TP_CALLS.values()) + sum(TP_RECOMPUTE.values())
                     + sum("model" in g for g in norm_groups) + len(differ)
                     + sum(1 + ("model" in _axes_of(specs[n]))
                           for n in regrouped))
    assert calls("model", "all-to-all") == TP_CALLS["all_to_all"]
    # the working copy: one all-gather over "data" a leaf sharded over it,
    # its bytes the working shards' (each leaf's working layout)
    with_data = [n for n, s in specs.items() if "data" in _axes_of(s)]
    assert calls("data", "all-gather") == len(with_data)

    def working_bytes(n):
        parts = math.prod(M_AXIS for a in _axes_of(work[n]) if a == "model") \
            if work[n] != REGROUPED else 1
        return leaves[n].numel() * 4 // parts
    gathered = sum(working_bytes(n) for n in with_data
                   if work[n] != REGROUPED)
    if not regrouped:
        assert got["data"]["all-gather"][1] == gathered
    # the gradient: one all-reduce over the batch axes a leaf, the loss,
    # and the norm's sums over the sets of axes that name the axis
    inner = ("data",) if mesh == "single" else ("pod", "data")
    for axis in inner:
        assert calls(axis, "all-reduce") == (
            len(specs) + 1 + sum(axis in g for g in norm_groups))


# ----------------------------------- (d) the reference's records beside --
REFERENCE_SCRIPT = r"""
import json, sys
from repro.launch import dryrun as D       # fakes 512 devices on import
from repro import configs as C
cells, out = json.loads(sys.argv[1]), sys.argv[2]
get = C.get
recs = []
for arch, shape, mesh, smoke in cells:
    C.get = C.smoke if smoke else get
    if smoke:
        C.SHAPES[shape] = {"seq": %d, "batch": %d, "kind": shape[5:]}
    try:
        recs.append(D.run_cell(arch, shape, mesh))
    except Exception as exc:
        recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "error", "error": repr(exc)[:300]})
json.dump(recs, open(out, "w"))
""" % (S, B)


def _row(rec):
    if rec.get("status") != "ok":
        return {"status": rec.get("status"), "error": rec.get("error")}
    rf = rec["roofline"]
    return {"status": "ok", "flops": rf["flops_per_device"],
            "peak": rec["memory"]["peak_estimate_bytes"],
            "collective_bytes": rf["collective_bytes"],
            "collectives": rf["collective_breakdown"]}


def test_reference_records_beside_the_ports(tmp_path, monkeypatch):
    cells = [(a, f"wide_{k}", m, True) for a in REFERENCE_SMOKE
             for k in ("prefill", "decode") for m in ("single", "multi")]
    cells += [(a, s, m, False) for a, s, m in FULL_CELLS]
    out = tmp_path / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, json.dumps(cells), str(out)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = []
    for kind in ("prefill", "decode"):
        monkeypatch.setitem(configs.SHAPES, f"wide_{kind}",
                            {"seq": S, "batch": B, "kind": kind})
    for arch, shape, mesh, smoke in cells:
        port.append(dryrun.run_cell(
            arch, shape, mesh, cfg=configs.smoke(arch) if smoke else None))
    log, _ = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, log[-3000:]
    ref = json.loads(out.read_text())
    side = [{"cell": c[:3], "port": _row(p), "reference": _row(r)}
            for c, p, r in zip(cells, port, ref)]
    (tmp_path / "side_by_side.json").write_text(json.dumps(side, indent=1))
    for c, p, r in zip(cells, port, ref):
        assert r["status"] == "ok", (c, r.get("error"))
        assert p["status"] == "ok", (c, p.get("error"))
        assert p["chips"] == r["chips"] == DP[c[2]] * M_AXIS
        assert p["roofline"]["collective_bytes"] > 0
        assert set(p["roofline"]["collective_breakdown"]) == set(
            r["roofline"]["collective_breakdown"])


# -------------------------------------------------- (e) the launchers ----
def test_launchers_on_the_production_meshes(tmp_path):
    spec = {"shapes": {"single": (2, 2), "multi": (2, 1, 2)},
            "arch": "internlm2_1_8b",
            "train": {"steps": 2, "batch": 4, "seq": 32},
            "serve": {"arch": "internlm2_1_8b", "requests": 4,
                      "prompt_len": 16, "decode_steps": 3}}
    out = str(tmp_path / "launchers")
    R.spawn(R.run_cases, 4, tmp_path,
            [("production_launchers", spec, out)])
    for rank in range(4):
        seen = json.loads(Path(f"{out}.rank{rank}.json").read_text())
        assert "needs 256 ranks" in seen["refused"][0], seen["refused"]
        assert "needs 512 ranks" in seen["refused"][1], seen["refused"]
        for name in ("single", "multi", "multi_compressed"):
            run = seen[name]
            assert (run["printed"] > 0) == (rank == 0), (rank, run)
            if rank == 0:                 # rank 0 alone prints
                assert run["launcher"] == run["direct"], (name, run)
                assert len(run["launcher"]) == 2
        assert seen["multi"]["direct"] != seen["multi_compressed"]["direct"]
        sv = seen["serve"]
        assert sv["rc"] == 0 and (sv["printed"] > 0) == (rank == 0)
        z = np.load(f"{out}.serve{rank}.npz")
        b = spec["serve"]["requests"] // sv["dp"]
        want = z["alone"][sv["dp_rank"] * b:(sv["dp_rank"] + 1) * b]
        rel = np.linalg.norm(z["mesh"] - want) / np.linalg.norm(want)
        assert rel <= 1e-5, rel          # test_torch_mesh_serve's SERVE_F32


def test_no_launcher_starts_the_fake_backend(tmp_path, monkeypatch):
    seen = []
    real = dist.init_process_group

    def recording(backend=None, *a, **k):
        seen.append(backend)
        return real(backend, *a, **k)

    monkeypatch.setattr(dist, "init_process_group", recording)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    kept = R.patched_production({"single": (1, 1), "multi": (1, 1, 1)})
    try:
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "multi",
                     "--steps", "1", "--batch", "2", "--seq", "32",
                     "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
        assert tserve.main(["--reduced", "--device", "cpu", "--mesh",
                            "single", "--requests", "2", "--prompt-len",
                            "16", "--decode-steps", "2"]) == 0
        M.start_group("cpu")
        dist.destroy_process_group()
    finally:
        M.PRODUCTION.update(kept)
    assert seen and "fake" not in seen and set(seen) == {"gloo"}
    assert not dist.is_initialized()
