"""The port's compile analysis on its own (no JAX): ``launch.op_count`` on
``meta`` tensors counts what the same step counts on the CPU, single ops
count as worked out by hand, the breakdown sums to the totals, and the dry
run's records and tables, on one card and on the production meshes."""
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun, op_breakdown, op_count, report
from repro_torch.launch import roofline as R
from repro_torch.models import init_params
from repro_torch.models.transformer import abstract_params, init_cache
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.train import AdamW, make_train_step

B, S = 2, 64
KINDS = ("prefill", "decode", "train")
FAMILIES = {"dense": "internlm2_1_8b", "moe": "olmoe_1b_7b",
            "ssm": "mamba2_780m", "hybrid": "zamba2_2_7b"}
# the reference's record keys that mean the same in the port's
REFERENCE_KEYS = ("arch", "shape", "mesh", "status", "kind", "chips", "seq",
                  "batch", "n_params", "n_params_active", "memory",
                  "roofline", "model_flops", "useful_flops_ratio")
ROOFLINE_KEYS = ("flops_per_device", "hbm_bytes_per_device",
                 "attn_bytes_per_device", "flash_io_bytes_per_device",
                 "collective_bytes", "collective_breakdown",
                 "collective_counts", "compute_s", "memory_s",
                 "memory_s_flash", "collective_s", "dominant")


@pytest.fixture
def smoke_shapes(monkeypatch):
    for kind in KINDS:
        monkeypatch.setitem(configs.SHAPES, f"smoke_{kind}",
                            {"seq": S, "batch": B, "kind": kind})


def _cpu_step(cfg, kind):
    """The cell's step on the CPU on seeded data of the cell's shapes."""
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, gen, "cpu", trainable=(kind == "train"))
    specs, _ = configs.input_specs(cfg, f"smoke_{kind}")
    batch = {}
    for name, t in specs.items():
        if name == "cache":
            batch[name] = init_cache(cfg, B, S, fill_len=S - 1, device="cpu")
        elif t.dtype == torch.int32:
            batch[name] = torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                        dtype=t.dtype)
        else:
            batch[name] = torch.randn(t.shape, generator=gen).to(t.dtype)
    if kind == "train":
        opt = AdamW()
        return make_train_step(cfg, opt), (model, opt.init(model), batch)
    if kind == "prefill":
        return make_prefill_step(cfg, device="cpu"), (model, batch)
    return make_serve_step(cfg, device="cpu"), (model, batch)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_meta_counts_what_the_cpu_counts(family, kind, smoke_shapes):
    cfg = configs.smoke(FAMILIES[family])
    _, step, args = dryrun.cell_step(cfg, f"smoke_{kind}",
                                     abstract_params(cfg))
    meta = op_count.analyze(step, *args)
    cpu = op_count.analyze(*(lambda s, a: (s, *a))(*_cpu_step(cfg, kind)))
    assert meta.flops > 0 and meta.bytes > 0
    for key in ("flops", "flops_by_dtype", "bytes", "attn_bytes",
                "cast_bytes", "argument_bytes", "peak_estimate_bytes"):
        assert getattr(meta, key) == getattr(cpu, key), key
    assert (meta.attn_bytes > 0) == (family != "ssm" or kind != "decode")
    assert meta.cast_bytes > 0


def _one(fn, *args):
    seen = []
    cost = op_count.analyze(fn, *args,
                            attribute=lambda k, b, f: seen.append((k, b, f)))
    return cost, seen


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_single_op_counts_by_hand(device):
    bf, f32 = torch.bfloat16, torch.float32
    a = torch.zeros((8, 16), dtype=bf, device=device)
    w = torch.zeros((16, 32), dtype=bf, device=device)
    cost, seen = _one(torch.mm, a, w)
    assert cost.flops == 2 * 8 * 16 * 32
    assert cost.flops_by_dtype == {"bfloat16": 2 * 8 * 16 * 32}
    assert cost.bytes == 2 * (8 * 16 + 16 * 32 + 8 * 32)
    assert seen == [("mm (8, 32)", cost.bytes, cost.flops)]

    x = torch.zeros((3, 8, 16), dtype=f32, device=device)
    y = torch.zeros((3, 16, 4), dtype=f32, device=device)
    cost, _ = _one(torch.bmm, x, y)
    assert cost.flops_by_dtype == {"float32": 2 * 3 * 8 * 16 * 4}
    assert cost.bytes == 4 * (3 * 8 * 16 + 3 * 16 * 4 + 3 * 8 * 4)

    cost, _ = _one(torch.add, x, x)                 # elementwise
    assert (cost.flops, cost.bytes) == (0, 3 * 4 * 3 * 8 * 16)
    cost, _ = _one(lambda t: t.view(24, 16), x)     # a view
    assert (cost.bytes, cost.temp_bytes) == (0, 0)
    row = torch.zeros((16,), dtype=f32, device=device)
    cost, _ = _one(lambda t, r: t.add_(r), x, row)  # in place, broadcast
    assert cost.bytes == 4 * (2 * 3 * 8 * 16 + 16)
    assert (cost.temp_bytes, cost.alias_bytes) == (0, 4 * 3 * 8 * 16)
    cost, _ = _one(lambda t: t.to(bf), x)           # a cast
    assert cost.bytes == cost.cast_bytes == 3 * 8 * 16 * (4 + 2)
    assert cost.output_bytes == cost.temp_bytes == 3 * 8 * 16 * 2


def test_peak_follows_the_storages_alive():
    x = torch.zeros((1024,), device="meta")         # 4 KiB

    def f(t):
        a = t * 2                                    # 4 KiB
        b = a + 1                                    # 8 KiB alive
        del a
        c = b * 3                                    # 8 KiB alive
        return c[:10]                                # a view of c
    cost = op_count.analyze(f, x)
    assert cost.argument_bytes == 4096
    assert cost.temp_bytes == 8192
    assert cost.output_bytes == 4096
    assert cost.peak_estimate_bytes == 4096 + 8192
    assert op_count.storages_outlive_their_wrappers()


def test_attn_core_scope_and_kernel_dtype():
    x = torch.zeros((4, 4), dtype=torch.bfloat16, device="meta")

    def f(t):
        with op_count.attn_core:
            u = t * 2
        with op_count.kernel_dtype(torch.float32):
            return torch.mm(u, u) + t
    cost = op_count.analyze(f, x)
    assert cost.attn_bytes == 2 * 32              # t read, u written
    assert cost.flops_by_dtype == {"float32": 2 * 4 * 4 * 4}
    with op_count.attn_core, op_count.kernel_dtype(torch.float32):
        assert op_count._COUNTER is None          # no count: nothing kept
    with pytest.raises(RuntimeError, match="nest"):
        op_count.analyze(lambda t: op_count.analyze(torch.neg, t), x)


def test_model_kernels_run_their_plain_versions_on_meta():
    q = torch.empty((2, 64, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 2, 16), dtype=torch.bfloat16, device="meta")
    assert fa.flash_attention(q, k, k).shape == q.shape
    xs = torch.empty((2, 64, 4, 16), dtype=torch.bfloat16, device="meta")
    bm = torch.empty((2, 64, 8), dtype=torch.bfloat16, device="meta")
    dt = torch.empty((2, 64, 4), dtype=torch.bfloat16, device="meta")
    a = torch.empty((4,), device="meta")
    y, st = ss.ssd_scan(xs, bm, bm, dt, a, 16)
    assert (y.shape, st.shape) == (xs.shape, (2, 4, 16, 8))
    cost = op_count.analyze(lambda *t: ss.ssd_scan(*t, 16), xs, bm, bm, dt, a)
    assert set(cost.flops_by_dtype) == {"bfloat16"}
    assert fa.LAUNCHES == 0 and ss.LAUNCHES == 0


@pytest.mark.parametrize("kind", KINDS)
def test_breakdown_sums_to_the_totals(kind, smoke_shapes):
    cfg = configs.smoke("zamba2_2_7b")
    _, step, args = dryrun.cell_step(cfg, f"smoke_{kind}",
                                     abstract_params(cfg))
    by_bytes, by_flops = op_breakdown.breakdown(step, *args)
    _, step, args = dryrun.cell_step(cfg, f"smoke_{kind}",
                                     abstract_params(cfg))
    cost = op_count.analyze(step, *args)
    assert sum(by_bytes.values()) == cost.bytes
    assert sum(by_flops.values()) == cost.flops
    text = op_breakdown.report(by_bytes, by_flops, "zamba2", 5)
    assert "top 5 by bytes" in text and "top 10 by flops" in text


def test_run_cell_skips_long_context_on_full_attention():
    rec = dryrun.run_cell("internlm2_1_8b", "long_500k")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


@pytest.mark.parametrize("family", FAMILIES)
def test_run_cell_record_has_the_reference_keys(family, smoke_shapes):
    arch = FAMILIES[family]
    rec = dryrun.run_cell(arch, "smoke_prefill", cfg=configs.smoke(arch))
    assert rec["status"] == "ok"
    for key in REFERENCE_KEYS:
        assert key in rec, key
    for key in ROOFLINE_KEYS:
        assert key in rec["roofline"], key
    assert rec["chips"] == 1 and rec["mesh"] == "host"
    assert rec["roofline"]["collective_s"] == 0.0
    assert set(rec["roofline"]["collective_counts"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                          + mem["temp_bytes"])
    assert mem["fits_card"]
    assert "xla_cost_flops" not in rec and "compile_s" not in rec


def test_decode_keeps_its_attention_bytes_on_the_kernel_path(smoke_shapes):
    cfg = configs.smoke("internlm2_1_8b")
    rec = dryrun.run_cell("internlm2_1_8b", "smoke_decode", cfg=cfg)
    rf = rec["roofline"]
    assert rf["attn_bytes_per_device"] > 0
    assert rf["memory_s_flash"] == rf["memory_s"]
    pre = dryrun.run_cell("internlm2_1_8b", "smoke_prefill", cfg=cfg)
    assert pre["roofline"]["memory_s_flash"] < pre["roofline"]["memory_s"]


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_only_the_host_mesh(mesh, tmp_path):
    """Not the host mesh only any more: ``--mesh single|multi|both`` writes
    rank 0's record on each production mesh, with its ranks and its
    collectives by the reference's five kinds; a mesh of no such name is
    refused."""
    out = str(tmp_path / "dry")
    recs = dryrun.main(["--mesh", mesh, "--arch", "internlm2_1_8b",
                        "--shape", "decode_32k", "--out", out])
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    assert [r["mesh"] for r in recs] == meshes
    assert sorted(f.name for f in (tmp_path / "dry").iterdir()) == sorted(
        f"internlm2_1_8b__decode_32k__{m}.json" for m in meshes)
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert r["chips"] == {"single": 256, "multi": 512}[r["mesh"]]
        rf = r["roofline"]
        assert rf["collective_bytes"] == sum(
            rf["collective_breakdown"].values()) > 0
        assert set(rf["collective_counts"]) == set(R.no_collectives()
                                                  .count_by_kind)
        assert rf["collective_s"] == rf["collective_bytes"] / R.LINK_BW
        assert set(r["collectives_by_axis"]) <= {"pod", "data", "model"}
        assert r["memory"]["fits_card"]
    with pytest.raises(ValueError, match="one of"):
        dryrun.run_cell("internlm2_1_8b", "decode_32k", "pods")


def test_main_writes_records_and_the_report_reads_them(tmp_path, capsys):
    out = str(tmp_path / "dry")
    recs = dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k",
                        "--out", out])
    assert [r["status"] for r in recs] == ["ok"]
    assert dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k",
                        "--out", out, "--skip-existing"]) == []
    files = list((tmp_path / "dry").iterdir())
    assert [f.name for f in files] == ["mamba2_780m__long_500k__host.json"]
    assert json.loads(files[0].read_text())["memory"]["fits_card"]
    text = report.main([out])
    assert "1 ok / 0 skipped / 0 errors" in text
    assert "mamba2_780m | long_500k" in capsys.readouterr().out


def test_report_tables_render_errors_and_skips(smoke_shapes):
    ok = dryrun.run_cell("olmoe_1b_7b", "smoke_train",
                         cfg=configs.smoke("olmoe_1b_7b"))
    rows = [ok,
            dryrun.run_cell("qwen15_4b", "long_500k"),
            {"arch": "qwen15_4b", "shape": "train_4k", "mesh": "host",
             "status": "error", "error": "RuntimeError: boom"}]
    table = report.roofline_table(rows)
    lines = table.splitlines()
    assert len(lines) == 5
    assert "skipped" in lines[3] and "ERROR" in lines[4] and "boom" in lines[4]
    assert ok["roofline"]["dominant"] in lines[2]
    detail = report.dryrun_table(rows).splitlines()
    assert len(detail) == 5 and "| error |" in detail[4]
    assert "Mean roofline fraction" in report.summary_stats(rows)
    assert report.cell_fraction(ok) > 0
    assert report.bottleneck_note(ok)


def test_roofline_splits_compute_by_dtype():
    cost = op_count.OpCost(flops=2e12, flops_by_dtype={"bfloat16": 1e12,
                                                       "float32": 1e12},
                           bytes=3.35e12, attn_bytes=1e12)
    roof = R.roofline_from_cost(cost, flash_io_bytes=0.5e12)
    assert roof.compute_s == pytest.approx(1e12 / 989e12 + 1e12 / 67e12)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.flash_bytes == pytest.approx(2.85e12)
    assert roof.dominant == "memory" and roof.collective_s == 0.0
    assert roof.bound_s == roof.memory_s_flash


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_replayed_calls_count_what_running_them_counts(family, kind,
                                                       smoke_shapes,
                                                       monkeypatch):
    """``op_count.replay``/``plain_kernel`` (the plain kernels and the
    backward passes on ``meta``) give the counts of running every call."""
    cfg = configs.smoke(FAMILIES[family])

    def count():
        _, step, args = dryrun.cell_step(cfg, f"smoke_{kind}",
                                         abstract_params(cfg))
        return op_count.analyze(step, *args)
    replayed = count()
    monkeypatch.setattr(op_count._Counter, "replayed",
                        lambda self, fn, args: fn(*args))
    ran = count()
    for key in ("flops", "flops_by_dtype", "bytes", "attn_bytes",
                "cast_bytes", "argument_bytes", "output_bytes",
                "temp_bytes", "peak_estimate_bytes"):
        assert getattr(replayed, key) == getattr(ran, key), key
