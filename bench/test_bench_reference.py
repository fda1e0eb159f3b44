"""The plain reference against the program's own plain path (its CPU
path: the kernels' plain versions) at SMOKE sizes, both in float32, on
the benchmark's seeded weights: InternLM2's prefill logits, and its step
losses and updated weights after two AdamW steps, with the LM head of
its own as published and tied to the embedding."""
import json

import pytest
import torch

from bench import harness, manifest, weights
from bench.reference import adamw
from bench.reference import model as ref

SMOKE = {
    "internlm2-1.8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                           head_dim=16, d_ff=128, vocab=256)}


def smoke(name: str, **changes) -> dict:
    c = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    c.update(SMOKE[name], **changes)
    return c


@pytest.fixture
def float32(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("tied", [False, True])
def test_internlm2_prefill_logits(float32, tied):
    from repro_torch.serve.serve_step import make_prefill_step
    c = smoke("internlm2-1.8b", tie_embeddings=tied)
    assert ("lm_head" in weights.make(c, 0, "cpu")) is not tied
    cfg = harness.arch_config(c)
    w = weights.make(c, 11, "cpu")
    model = harness.load_model(c, cfg, w, "cpu", trainable=False)
    tokens = torch.randint(0, c["vocab"], (3, 64),
                           generator=torch.Generator().manual_seed(0))
    got = make_prefill_step(cfg, device="cpu")(model, {"tokens": tokens})
    want = ref.last_logits(w, tokens, c)
    torch.testing.assert_close(got[:, -1], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tied", [False, True])
def test_internlm2_train_steps(float32, tied):
    from repro_torch.train import AdamW, make_train_step
    c = smoke("internlm2-1.8b", tie_embeddings=tied)
    cfg = harness.arch_config(c)
    o = json.loads((manifest.BENCH / "traffic" / "train-4k.json")
                   .read_text())["optimizer"]
    model = harness.load_model(c, cfg, weights.make(c, 12, "cpu"), "cpu",
                               trainable=True)
    opt = AdamW(**{k: o[k] for k in ("lr", "b1", "b2", "eps",
                                     "weight_decay", "clip_norm")})
    state, step = opt.init(model), make_train_step(cfg, opt)
    w = {n: t.requires_grad_(True) for n, t in
         weights.make(c, 12, "cpu").items()}
    ropt = adamw.AdamW(w, **o)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        rows = torch.randint(0, c["vocab"], (4, 33), generator=g)
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        model, state, m = step(model, state, batch)
        loss = ref.loss(w, batch["tokens"], batch["labels"], c)
        loss.backward()
        ropt.step()
        assert float(m["loss"]) == pytest.approx(float(loss.detach()),
                                                 rel=1e-6)
    params = dict(model.named_parameters())
    for name, t in weights.layer_leaves(w).items():
        torch.testing.assert_close(params[name].detach(), t.detach(),
                                   rtol=1e-5, atol=1e-5)
