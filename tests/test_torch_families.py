"""The port's last two families on the CPU against the JAX package: the
encoder-decoder (``seamless_m4t_medium``) and the vision-language model
(``llava_next_34b``), SMOKE configs with the reference's weights carried by
``from_reference`` and the stub frontends' inputs (frame and patch
embeddings) seeded with numpy.

* ``forward``, ``forward(last_only=True)``, 8 cached ``decode_step``s and
  every cache leaf (the encoder-decoder's ``enc_k``/``enc_v`` filled with the
  same seeded rows on both sides);
* the prefill against the port's own token-by-token decode, the decode
  cache's encoder K/V filled from the prefill's own encoder code
  (``transformer._encode`` and ``cross_kv_init``), the patch embeddings the
  prompts' own token embeddings;
* ``loss_fn`` (the vlm's patch mask) and every gradient leaf against
  ``jax.grad`` of the reference, with and without remat;
* ``input_specs`` and ``cell_supported`` against the reference for every
  arch and shape cell, the weight layouts, the carry both ways;
* ``_sdpa_core``'s routing: non-causal attention with more than one query
  reaches ``ops.flash_attention`` whatever Sk is, the offset decode and a
  single query do not;
* the serve driver's refusals: an encoder-decoder, and a vlm prompt
  shorter than its patches (``PlanError``).

Tolerances, as ``tests/test_torch_models.py`` and
``tests/test_torch_train.py`` hold the other families: in float32 (both
packages' ``COMPUTE_DTYPE`` patched) 1e-4 for logits and caches, 1e-5
relative for the loss and 1e-4 relative L2 a gradient leaf; in bf16
``launch.serve.prefill_bound`` relative L2 (sqrt(2) times it a gradient
leaf).  The encoder-decoder's bound counts its decoder blocks only (its
encoder is shared by the serving check's two paths); against the
reference the encoder rounds differently too, and the observed distance
(≈0.016 on three seeds) stays a third of the bound (0.049)."""
import dataclasses
import functools
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import (decode_step, forward, from_reference,
                                init_cache, init_params, loss_fn,
                                reference_like, to_reference)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import state_dict_from_reference

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_cross_cache  # noqa: E402

ARCHS = ["seamless_m4t_medium", "llava_next_34b"]
F32_TOL = 1e-4
LOSS_F32 = 1e-5
GRAD_F32 = 1e-4
SEQ = 32
ENC_SEQ = 40        # frames: the encoder's length need not be the decoder's
DECODE = 8


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


@pytest.fixture(params=["f32", "bf16"])
def compute(request, monkeypatch):
    if request.param == "f32":
        monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    return request.param


@functools.lru_cache(maxsize=None)
def _tree(arch):
    cfg = RC.smoke(arch)
    return jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.key(0)))


def _batch(cfg, b=2, s=SEQ, seed=1, labels=False) -> dict:
    """Seeded tokens and the family's stub frontend input, numpy float32
    (each package casts it to its compute dtype)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1]}
    if labels:
        out["labels"] = toks[:, 1:]
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (b, ENC_SEQ, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, compute, bound):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if compute == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= bound, (rel, bound)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


# -------------------------------------------------- forward and decode --
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_the_reference(arch, compute):
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    tree = _tree(arch)
    model = from_reference(tcfg, tree, device="cpu")
    bound = prefill_bound(tcfg)
    batch = _batch(rcfg)
    before = fa.LAUNCHES
    for last_only in (False, True):
        want = RT.forward(tree, _jnp(batch), rcfg, last_only=last_only)
        with torch.inference_mode():
            got = forward(model, _torch(batch), tcfg, last_only=last_only)
        _close(got.float(), want, compute, bound)
    assert fa.LAUNCHES == before                  # the CPU never launches

    steps = np.random.default_rng(2).integers(0, rcfg.vocab, (2, DECODE)
                                              ).astype(np.int32)
    max_len = DECODE + 4
    rcache = RT.init_cache(rcfg, 2, max_len)
    tcache = init_cache(tcfg, 2, max_len, device="cpu")
    assert set(tcache) == set(rcache)
    if rcfg.family == "encdec":
        rng = np.random.default_rng(3)
        for name in ("enc_k", "enc_v"):
            rows = rng.standard_normal(rcache[name].shape).astype(np.float32)
            rcache[name] = jnp.asarray(rows, rcache[name].dtype)
            tcache[name].copy_(torch.from_numpy(rows))
    step = jax.jit(functools.partial(RT.decode_step, cfg=rcfg))
    for t in range(DECODE):
        rl, rcache = step(tree, {"tokens": jnp.asarray(steps[:, t:t + 1])},
                          rcache)
        with torch.inference_mode():
            tl, tcache = decode_step(model, {"tokens": torch.from_numpy(
                steps[:, t:t + 1])}, tcache, tcfg)
        _close(tl.float(), rl, compute, bound)
    for name, leaf in rcache.items():
        if name == "len":
            assert tcache[name] == int(leaf) == DECODE
        else:
            assert tcache[name].dtype == TL.COMPUTE_DTYPE
            _close(tcache[name].float(), leaf, compute, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_token_by_token_decode(arch, compute):
    """The serving prefill (flash for the encoder, the causal decoder and
    the cross-attention) against the port's decode path (the materialised
    softmax): the encoder-decoder's cache filled from the prefill's own
    encoder code over as many frames as the cache has slots (the decode
    attends to every slot), the vlm's patch embeddings the prompts' own
    token embeddings (the serve driver's stand-in)."""
    cfg = TC.smoke(arch)
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = _torch(_batch(cfg, seed=4))
    if cfg.family == "encdec":
        batch["enc_embeds"] = batch["enc_embeds"][:, :SEQ]
    else:
        batch["patch_embeds"] = TT._embed(model,
                                          batch["tokens"][:, :cfg.n_patches])
    toks = batch["tokens"]
    cache = init_cache(cfg, 2, SEQ, device="cpu")
    with torch.inference_mode():
        pre = forward(model, batch, cfg, last_only=True)
        if cfg.family == "encdec":
            fill_cross_cache(model, cfg, cache, batch["enc_embeds"])
        for t in range(SEQ):
            logits, cache = decode_step(model, {"tokens": toks[:, t:t + 1]},
                                        cache, cfg)
    _close(pre[:, -1, :cfg.vocab].float(), logits[:, -1].float(), compute,
           prefill_bound(cfg))


def test_vlm_patch_embeds_replace_the_first_positions():
    """The stub frontend: patch embeddings equal to the tokens' own
    embeddings give the token path's logits bit for bit, and others change
    every position's logits from the first on."""
    cfg = TC.smoke("llava_next_34b")
    model = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.inference_mode():
        own = forward(model, {"tokens": toks, "patch_embeds": TT._embed(
            model, toks[:, :cfg.n_patches])}, cfg)
        plain = forward(model, {"tokens": toks, "patch_embeds": TT._embed(
            model, toks)[:, :0]}, cfg)
        other = forward(model, {"tokens": toks, "patch_embeds": torch.zeros(
            (2, cfg.n_patches, cfg.d_model))}, cfg)
    assert torch.equal(own, plain)
    assert not torch.isclose(own[:, 0], other[:, 0]).all()


# -------------------------------------------------- loss and gradients --
@pytest.mark.parametrize("arch,remat", [(a, r) for a in ARCHS
                                        for r in (False, True)])
def test_loss_and_grads_match_reference_f32(arch, remat, monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    _loss_and_grads(arch, remat, LOSS_F32, GRAD_F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    bound = prefill_bound(TC.smoke(arch))
    _loss_and_grads(arch, False, bound, math.sqrt(2) * bound)


def _loss_and_grads(arch, remat, loss_tol, grad_tol):
    rcfg = dataclasses.replace(RC.smoke(arch), remat=remat)
    tcfg = dataclasses.replace(TC.smoke(arch), remat=remat)
    tree = _tree(arch)
    batch = _batch(rcfg, labels=True)
    want_loss, want = jax.value_and_grad(RT.loss_fn)(tree, _jnp(batch), rcfg)
    model = from_reference(tcfg, tree, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss = loss_fn(model, _torch(batch), tcfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    got = to_reference(model, dict(zip(named, grads)))
    assert abs(float(loss.detach()) - float(want_loss)) <= loss_tol * abs(
        float(want_loss))
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path], want[path]) <= grad_tol, path


def test_vlm_loss_skips_the_patch_positions():
    """Labels at the patch positions carry no weight: changing them leaves
    the loss unchanged; the sum over the other positions is divided by one
    row's count of them (the reference's (1, S) mask)."""
    cfg = TC.smoke("llava_next_34b")
    model = init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    batch = _torch(_batch(cfg, labels=True))
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :cfg.n_patches] = 0
    with torch.inference_mode():
        a, b = loss_fn(model, batch, cfg), loss_fn(model, other, cfg)
        logits = forward(model, batch, cfg).float()
    assert float(a) == float(b)
    lp = torch.log_softmax(logits, -1).gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    want = -lp[:, cfg.n_patches:].sum() / (lp.shape[1] - cfg.n_patches)
    assert abs(float(a) - float(want)) <= 1e-6 * abs(float(want))


# ------------------------------------------------ registry and layouts --
@pytest.mark.parametrize("shape", list(RC.SHAPES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_input_specs_and_cells_match_reference(arch, shape):
    assert TC.cell_supported(arch, shape) == RC.cell_supported(arch, shape)
    want, rkind = RC.input_specs(RC.get(arch), shape)
    got, kind = TC.input_specs(TC.get(arch), shape)
    assert kind == rkind and set(got) == set(want)
    dtypes = {np.dtype(np.int32): torch.int32,
              np.dtype(jnp.bfloat16): torch.bfloat16,
              np.dtype(np.float32): torch.float32}
    flat = dict(_leaves(got))
    for path, spec in _leaves(want):
        leaf = flat.pop(path)
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(spec.shape), path
        assert leaf.dtype == dtypes[np.dtype(spec.dtype)], path
    assert not flat


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_weights_have_the_reference_layout(arch):
    """init_params names and shapes every parameter as the carried
    reference tree does (the encoder's blocks, the decoder's ``lnx`` and
    ``xattn``, LLaVA's untied ``lm_head``), and draws the reference's
    distributions."""
    cfg = TC.smoke(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = state_dict_from_reference(_tree(arch))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    if cfg.family == "encdec":
        assert "enc_layers.1.attn.wq.w" in got and "layers.0.lnx" in got
        assert "layers.1.xattn.wo.w" in got and "enc_layers.0.lnx" not in got
        w = got["layers.0.xattn.wk.w"]
    else:
        assert "lm_head" in got and not any("xattn" in k for k in got)
        w = got["lm_head"]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.1
    assert torch.equal(got["final_norm"], torch.ones(cfg.d_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_inverts_the_carry(arch):
    tree = _tree(arch)
    model = from_reference(TC.smoke(arch), tree, device="cpu")
    back = to_reference(model)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(tree)]
    for (p, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b, err_msg=p)
    for (_, a), (_, b) in zip(_leaves(reference_like(model)), _leaves(tree)):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape


def test_weight_carry_refuses_an_encdec_tree_without_its_encoder():
    tree = dict(_tree("seamless_m4t_medium"))
    del tree["enc_layers"]
    with pytest.raises(RuntimeError, match="enc_layers"):
        from_reference(TC.smoke("seamless_m4t_medium"), tree, device="cpu")


# ---------------------------------------------------------- routing --
def _recording(monkeypatch) -> list:
    calls = []
    real = ops.flash_attention

    def flash(q, k, v, causal=True):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal)
    monkeypatch.setattr(ops, "flash_attention", flash)
    return calls


@pytest.mark.parametrize("sq,sk,causal,q_offset,flash", [
    (32, 40, False, 0, True),      # a prefill's cross-attention
    (40, 32, False, 0, True),      # more queries than keys
    (32, 32, False, 0, True),      # the encoder's self-attention
    (32, 32, True, 0, True),       # a causal prefill
    (1, 40, False, 0, False),      # the decode's cross-attention
    (1, 40, True, 7, False),       # the offset decode
    (32, 40, True, 0, False),      # causal, Sq != Sk: no query offset
])
def test_sdpa_core_routes_non_causal_prefills_to_flash(
        monkeypatch, sq, sk, causal, q_offset, flash):
    calls = _recording(monkeypatch)
    rng = np.random.default_rng(sq * sk)
    q = torch.from_numpy(rng.standard_normal((2, sq, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, sk, 2, 16)).astype(
        np.float32)) for _ in range(2))
    got = TL._sdpa_core(q, k, v, causal, q_offset)
    assert calls == ([(sq, sk, causal)] if flash else [])
    want = ref.mha_ref(q, k, v, causal, q_offset)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_encdec_prefill_reaches_flash_in_every_attention(monkeypatch):
    """One prefill: the encoder's self-attention, the decoder's causal
    self-attention and its cross-attention (Sq 32 against 40 frames) each
    reach the flash wrapper once a layer; the decode step none."""
    cfg = TC.smoke("seamless_m4t_medium")
    calls = _recording(monkeypatch)
    model = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    batch = _torch(_batch(cfg))
    with torch.inference_mode():
        forward(model, batch, cfg, last_only=True)
        assert sorted(calls) == sorted(
            [(SEQ, ENC_SEQ, False)] * cfg.n_layers
            + [(SEQ, SEQ, True)] * cfg.n_layers
            + [(ENC_SEQ, ENC_SEQ, False)] * cfg.n_enc_layers)
        calls.clear()
        cache = init_cache(cfg, 2, ENC_SEQ, device="cpu")
        decode_step(model, {"tokens": batch["tokens"][:, :1]}, cache, cfg)
    assert calls == []


# ------------------------------------------------------------ driver --
def test_serve_driver_refuses_an_encoder_decoder():
    cfg = tserve.reduced_config(TC.get("seamless_m4t_medium"))
    with pytest.raises(ValueError, match="encdec serving needs enc_embeds"):
        tserve.serve(cfg, requests=1, prompt_len=16, decode_steps=1,
                     device="cpu")
    with pytest.raises(SystemExit, match="encdec serving needs enc_embeds"):
        tserve.main(["--arch", "seamless_m4t_medium", "--reduced",
                     "--device", "cpu"])


def test_serve_driver_refuses_a_prompt_shorter_than_its_patches():
    """The reference would concatenate 16 patch rows before an 8-token
    prompt's embeddings and serve a 16-token sequence; the port refuses."""
    cfg = tserve.reduced_config(TC.get("llava_next_34b"))
    assert cfg.n_patches == 16
    with pytest.raises(build.PlanError, match="16 patch positions"):
        tserve.serve(cfg, requests=1, prompt_len=8, decode_steps=1,
                     device="cpu")


def test_serve_driver_serves_a_vlm_through_its_patch_stand_in(monkeypatch):
    """bf16, ``--reduced``: the prefill (patch embeddings the prompts' own
    token embeddings) meets the token path's check, and the prefill
    reaches the flash wrapper once a layer."""
    cfg = tserve.reduced_config(TC.get("llava_next_34b"))
    calls = _recording(monkeypatch)
    run = tserve.serve(cfg, requests=2, prompt_len=32, decode_steps=3,
                       device="cpu", log=lambda *_: None)
    assert run["check"]["ok"], run["check"]
    assert calls == [(32, 32, True)] * cfg.n_layers
    assert run["cache"]["len"] == 32 + 3 - 1
