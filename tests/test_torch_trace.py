"""The port's tracer (``repro_torch.trace``) on the CPU: nothing recorded
and no ``record_function`` entered while tracing is off; the span tree of
a SMOKE-size remat training step (ids, parents, self time); the
profiler's trace holding the spans as ``user_annotation`` events;
``model.weight_cast_bytes`` against its closed form; the operator's
``--trace`` file of both launchers; the flash backward's span on the
CPU's plain path; and the benchmark's readers of the spans and counters
on hand-built traces, with the backward kernel's closed form."""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, trace
from repro_torch.core import generate, lyresplit_for_budget, to_tree
from repro_torch.data import VersionedDataset
from repro_torch.models import init_params
from repro_torch.serve import BatchedCheckoutServer
from repro_torch.serve.serve_step import make_prefill_step
from repro_torch.train import AdamW, make_train_step

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench import manifest  # noqa: E402
from bench.devtrace import Trace  # noqa: E402

# InternLM2's shape at SMOKE size, with the benchmark's untied head
CFG = dataclasses.replace(configs.smoke("internlm2_1_8b"),
                          tie_embeddings=False, remat=True)


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _model():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu",
                       trainable=True)


def _batch(b=2, s=32):
    toks = torch.randint(0, CFG.vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train_step(model):
    opt = AdamW(lr=1e-3)
    return make_train_step(CFG, opt)(model, opt.init(model), _batch())


def _prefill(model):
    return make_prefill_step(CFG, device="cpu")(
        model, {"tokens": _batch()["tokens"]})


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.on()
    model = _model()
    _train_step(model)
    _prefill(model)
    w = generate("CUR", n_versions=4, inserts=20, n_branches=2, n_attrs=8,
                 seed=0)
    tree, _ = to_tree(w.graph, w.vgraph)
    ds = VersionedDataset.from_graph(
        w.graph, w.data, lyresplit_for_budget(tree, 2.0 * w.n_records
                                              ).best.assignment,
        seq_len=7, device="cpu")
    with BatchedCheckoutServer(ds.store, use_kernel=True) as srv:
        srv.serve([0, 1])
    next(ds.batches(0, global_batch=2))
    assert trace.spans() == [] and trace.counters() == {}


def _by_id(spans):
    return {s.id: s for s in spans}


def test_remat_train_step_span_tree():
    model = _model()
    trace.enable()
    _train_step(model)
    spans = trace.spans()
    ids = _by_id(spans)
    assert len(ids) == len(spans)
    root, = [s for s in spans if s.name == "train.step"]
    assert root.parent is None and root.attrs == {"step": 0}
    kids = {s.name for s in spans if s.parent == root.id}
    assert kids == {"train.forward", "train.backward", "train.optimizer"}
    fwd, = [s for s in spans if s.name == "train.forward"]
    bwd, = [s for s in spans if s.name == "train.backward"]

    def under(name, parent):
        return [s for s in spans if s.name == name and s.parent == parent.id]
    # each block in the forward and again in remat's recompute
    assert len(under("model.block", fwd)) == CFG.n_layers
    assert len(under("model.block", bwd)) == CFG.n_layers
    assert len(under("model.head", fwd)) == 1
    assert len(under("attn.backward", bwd)) == CFG.n_layers
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        covered = sum(k.end_ns - k.start_ns for k in spans
                      if k.parent == s.id)        # children do not overlap
        assert s.self_ns == s.end_ns - s.start_ns - covered
    # the step's index counts its calls
    trace.clear()
    opt = AdamW(lr=1e-3)
    step = make_train_step(CFG, opt)
    state = opt.init(model)
    for _ in range(2):
        model, state, _ = step(model, state, _batch())
    assert [s.attrs["step"] for s in trace.spans()
            if s.name == "train.step"] == [0, 1]


def test_a_thread_with_no_open_span_takes_the_latest_open_one():
    trace.enable()
    got = {}

    def work():
        with trace.span("inner") as s:
            got["parent"] = s.parent
            with trace.span("leaf") as leaf:
                got["leaf"] = (leaf.parent, s.id)
    with trace.span("outer") as outer:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert got["parent"] == outer.id
    assert got["leaf"][0] == got["leaf"][1]
    inner, = [s for s in trace.spans() if s.name == "inner"]
    assert inner.thread != outer.thread


def test_threads_lose_no_span_or_count():
    """More threads than cores, each opening nested spans and counting
    with a short switch interval: every span is kept once with a parent
    of its own thread, and no count is lost."""
    import os
    n_threads = 2 * (os.cpu_count() or 4)
    reps = 200
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("n", 1)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = trace.spans()
    assert len(spans) == 2 * n_threads * reps
    assert len({s.id for s in spans}) == len(spans)
    ids = _by_id(spans)
    for s in spans:
        if s.name == "inner":
            assert ids[s.parent].name == "outer"
            assert ids[s.parent].thread == s.thread
    assert trace.counters() == {"n": n_threads * reps}


def test_ended_threads_leave_the_list_and_keep_their_counts():
    """A thread that has ended is dropped from the tracer's threads when
    the next one registers; its counts stay in ``counters()``."""
    trace.enable()

    def work():
        trace.count("n", 1)
    for _ in range(8):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    seen = {}

    def last():
        trace.count("n", 1)
        seen["alive"] = [o.thread.is_alive() for o in trace._S.threads]
    t = threading.Thread(target=last)
    t.start()
    t.join(timeout=60)
    assert seen["alive"] and all(seen["alive"])
    assert trace.counters() == {"n": 9}
    trace.clear()
    assert trace.counters() == {}


def test_span_store_is_bounded(monkeypatch, tmp_path):
    """Past ``MAX_SPANS`` closed spans are counted, not kept; the export
    says how many, and ``clear()`` starts again."""
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for i in range(5):
        with trace.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in trace.spans()] == [0, 1, 2]
    assert trace.dropped() == 2
    path = tmp_path / "t.json"
    trace.export_chrome(str(path))
    assert json.loads(path.read_text())["otherData"] == {"dropped_spans": 2}
    trace.clear()
    assert trace.dropped() == 0 and trace.spans() == []


def test_profiler_turns_tracing_on_and_holds_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        _prefill(model)
    assert not trace.on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert notes.count("serve.prefill") == 1
    assert notes.count("model.block") == CFG.n_layers
    assert notes.count("model.head") == 1
    root, = [s for s in trace.spans() if s.name == "serve.prefill"]
    assert root.attrs == {"b": 2, "s": 32}
    assert trace.counters()["model.weight_cast_bytes"] > 0


def _block_bytes(cfg) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    return 4 * (2 * d + d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd
                + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)


def test_weight_cast_bytes_closed_form():
    """A prefill reads each block's weights once and the head (the final
    norm and the LM head) once; a remat training step reads the blocks
    twice (the forward and the recompute), the head once, and each norm's
    scale once more in its backward."""
    model = _model()
    trace.enable()
    _prefill(model)
    d, layers = CFG.d_model, CFG.n_layers
    head = 4 * (CFG.vocab_padded * d + d)
    blocks = layers * _block_bytes(CFG)
    assert trace.counters() == {"model.weight_cast_bytes": blocks + head}
    trace.clear()
    _train_step(model)
    norms = 4 * d * (2 * layers + 1)
    assert trace.counters() == {
        "model.weight_cast_bytes": 2 * blocks + head + norms}


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launcher_trace_file_loads_and_nests(launcher, tmp_path, capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    path = tmp_path / "spans.json"
    argv = ["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu",
            "--trace", str(path)]
    if launcher == "train":
        ttrain.main(argv + ["--steps", "2", "--batch", "2", "--seq", "32",
                            "--ckpt-every", "0", "--ckpt-dir",
                            str(tmp_path / "ckpt")])
        want = {"train.step", "train.forward", "train.backward",
                "train.optimizer", "data.batch", "model.block",
                "model.head", "attn.backward"}
    else:
        tserve.main(argv + ["--requests", "2", "--prompt-len", "16",
                            "--decode-steps", "2"])
        want = {"serve.fill", "serve.decode", "serve.prefill",
                "checkout.flush", "checkout.dispatch", "checkout.deliver",
                "model.block", "model.head"}
    capsys.readouterr()
    assert not trace.on()
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["args"]["id"]: e for e in events if e["ph"] == "X"}
    assert want <= {e["name"] for e in spans.values()}
    for e in spans.values():
        p = spans.get(e["args"]["parent"])
        if p is not None:
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    counts = [e for e in events if e["ph"] == "C"]
    assert [e["name"] for e in counts] == ["model.weight_cast_bytes"]
    assert counts[0]["args"]["value"] > 0


# ------------------------------------------------- the benchmark's readers --
def _x(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def _hand_trace():
    """Busy [0, 100], [150, 300], [400, 500] µs of a 600 µs window; the
    prefill spans [90, 160] and [290, 420] (idle 50 + 100 µs), the
    checkout [500, 560] with a dispatch inside it (idle 60 µs)."""
    events = [_x("k", "kernel", 0, 100), _x("k", "kernel", 150, 100),
              _x("c", "gpu_memcpy", 200, 100), _x("k", "kernel", 400, 100),
              _x("serve.prefill", "user_annotation", 90, 70),
              _x("serve.prefill", "user_annotation", 290, 130),
              _x("model.block", "user_annotation", 95, 10),
              _x("checkout.flush", "user_annotation", 500, 60),
              _x("checkout.dispatch", "user_annotation", 510, 10),
              _x("aten::mm", "cpu_op", 520, 30)]
    return Trace(events, 600e-6)


def test_idle_readers_on_a_hand_built_trace():
    run = {"trace": _hand_trace()}
    fwd = manifest.reader("forward_idle_pct.prefill")(run)
    chk = manifest.reader("checkout_idle_pct.prefill")(run)
    idle = manifest.reader("device_idle_pct.prefill")(run)
    assert fwd == pytest.approx(25.0, rel=1e-12)
    assert chk == pytest.approx(10.0, rel=1e-12)
    assert idle == pytest.approx(100.0 * 250 / 600, rel=1e-12)
    assert fwd + chk <= idle


@pytest.mark.parametrize("name", ["forward_idle_pct.prefill",
                                  "checkout_idle_pct.prefill"])
def test_idle_readers_give_none_without_a_trace_or_spans(name):
    read = manifest.reader(name)
    assert read({"trace": None}) is None
    assert read({"trace": Trace([_x("k", "kernel", 0, 10)], 1e-3)}) is None


def _span(name, device_ms):
    s = trace.Span(name, {})
    s.device_ms = device_ms
    return s


def test_attn_backward_reader(monkeypatch):
    read = manifest.reader("attn_backward_pct.train")
    assert read({}) is None
    trace.enable()
    with trace.span("train.step"):       # no device time on the CPU
        with trace.span("attn.backward"):
            pass
    assert read({}) is None
    monkeypatch.setattr(trace, "spans", lambda: [
        _span("train.step", 8.0), _span("attn.backward", 3.0),
        _span("attn.backward", 1.0), _span("train.step", 2.0)])
    assert read({}) == pytest.approx(40.0, rel=1e-12)


@pytest.mark.parametrize("name,root", [("weight_cast_gb.prefill",
                                        "serve.prefill"),
                                       ("weight_cast_gb.train",
                                        "train.step")])
def test_weight_cast_readers(name, root):
    read = manifest.reader(name)
    assert read({}) is None
    trace.enable()
    trace.count("model.weight_cast_bytes", 3 * 10 ** 9)
    assert read({}) is None
    for _ in range(2):
        with trace.span(root):
            pass
    trace.disable()
    trace.count("model.weight_cast_bytes", 10 ** 9)   # off: not counted
    assert read({}) == pytest.approx(1.5, rel=1e-12)


# ------------------------------------ the flash backward's path and shape --
@pytest.mark.parametrize("causal,sk", [(True, 40), (False, 56)])
def test_flash_backward_on_cpu_takes_the_plain_path(causal, sk):
    """On the CPU the flash Function saves no lse, never launches the
    backward kernel, and opens its ``attn.backward`` span with the plain
    path and the call's shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g).requires_grad_(True)
    k, v = (torch.randn(2, sk, 2, 16, generator=g).requires_grad_(True)
            for _ in range(2))
    trace.enable()
    before = fa.BWD_LAUNCHES
    out = ops.flash_attention(q, k, v, causal)
    assert out.grad_fn.saved_tensors[4] is None
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert fa.BWD_LAUNCHES == before
    span, = [s for s in trace.spans() if s.name == "attn.backward"]
    assert span.attrs == {"path": "plain", "b": 2, "sq": 40, "sk": sk,
                          "h": 4, "hkv": 2, "dqk": 16, "dv": 16,
                          "causal": causal}


def test_flash_backward_counts_by_hand():
    from bench.counts import flash_bwd
    # the rows of a causal (Sq, Sk) mask: 1, 2, 3, 4 keys; 1, 2, 3, 3, 3;
    # 1, 2, 3
    assert flash_bwd.pairs(4, 4, True) == 10
    assert flash_bwd.pairs(5, 3, True) == 12
    assert flash_bwd.pairs(3, 5, True) == 6
    assert flash_bwd.pairs(3, 5, False) == 15
    # five products of 2 operations a pair and width: 3 over q·k, 2 over v
    assert flash_bwd.flops(1, 4, 4, 1, 2, 2, True) == 2 * 10 * (3 * 2 + 2 * 2)
    # q, o, dO, dq: 4 x 2 heads x 2 each; k, v, dk, dv: 4 x 1 x 2 each;
    # bf16; lse and delta 2 x 4 float32 a head
    assert flash_bwd.nbytes(1, 4, 4, 2, 1, 2, 2) == \
        (4 * 4 * 2 * 2 + 4 * 4 * 1 * 2) * 2 + 2 * 2 * 4 * 4
    # the train-4k cell's call: 1.375 TFLOP and 0.81 GB, bound by operations
    assert flash_bwd.flops(8, 4096, 4096, 16, 128, 128, True) == \
        2 * 8 * 16 * 8_390_656 * 640
    assert flash_bwd.nbytes(8, 4096, 4096, 16, 8, 128, 128) == \
        8 * 4096 * (16 * 512 + 8 * 512) * 2 + 8 * 8 * 16 * 4096


def test_flash_backward_roofline_reader(monkeypatch):
    from bench import peaks
    from bench.counts import flash_bwd
    read = manifest.reader("flash_backward_roofline.train")
    assert read({"trace": None}) is None
    kernels = Trace([_x("void flash_bwd_wgmma_kernel<128>", "kernel", 0,
                        900.0),
                     _x("void flash_bwd_dq_kernel<128>", "kernel", 900, 100.0),
                     _x("flash_fwd_wgmma_kernel", "kernel", 1000, 500.0)],
                    2e-3)
    shape = {"b": 2, "sq": 256, "sk": 256, "h": 4, "hkv": 2, "dqk": 64,
             "dv": 64, "causal": True}

    def span(path):
        s = trace.Span("attn.backward", {"path": path, **shape})
        s.device_ms = 1.0
        return s

    monkeypatch.setattr(trace, "spans", lambda: [span("plain")])
    assert read({"trace": kernels}) is None       # no kernel-path span
    monkeypatch.setattr(trace, "spans", lambda: [
        span("kernel"), span("kernel"), span("plain"),
        _span("train.step", 8.0)])
    bound = peaks.bound_s(flash_bwd.flops(2, 256, 256, 4, 64, 64, True),
                          flash_bwd.nbytes(2, 256, 256, 4, 2, 64, 64))
    assert read({"trace": kernels}) == pytest.approx(
        100 * 2 * bound / 1e-3, rel=1e-12)
    assert read({"trace": Trace([], 1e-3)}) is None
