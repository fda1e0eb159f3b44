"""The port's model side on the CPU against the JAX package, for the SMOKE
configs of the three families it serves (dense ``internlm2_1_8b``, ssm
``mamba2_780m``, hybrid ``zamba2_2_7b``), with the reference's weights
carried by ``from_reference``: ``forward``, ``forward(last_only=True)`` and 8
cached ``decode_step``s (logits and every cache leaf).

In float32 compute (both packages' ``COMPUTE_DTYPE`` patched inside the
test) the port agrees with the reference at rtol = atol = 1e-4.  In bf16 the
two round at different places (the flash kernel keeps the attention
probabilities in float32, the reference rounds them to bf16; sums run in
other orders), so they agree within ``launch.serve.prefill_bound``: a
relative L2 distance of sqrt(2 · 6 · depth) · 2^-8, bf16's rounding at six
places a block, added in quadrature over the blocks.  The prefill's
last-position logits equal the token-by-token decode's within the same
bounds, and the families this slice does not serve raise
``NotImplementedError``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import (decode_step, forward, from_reference,
                                init_cache, init_params)
from repro_torch.models import layers as TL
from repro_torch.models.convert import state_dict_from_reference
from repro_torch.models.transformer import ArchConfig

ARCHS = ["internlm2_1_8b", "mamba2_780m", "zamba2_2_7b"]
F32_TOL = 1e-4
SEQ = 32            # a multiple of every SMOKE chunk (16)
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


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def _close(got, want, compute, bound):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if compute == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= bound, (rel, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_the_reference(arch, compute):
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    tree = _tree(arch)
    model = from_reference(tcfg, tree, device="cpu")
    bound = prefill_bound(tcfg)
    toks = _tokens(rcfg, (2, SEQ))
    want = RT.forward(tree, {"tokens": jnp.asarray(toks)}, rcfg)
    want_last = RT.forward(tree, {"tokens": jnp.asarray(toks)}, rcfg,
                           last_only=True)
    before = (fa.LAUNCHES, ss.LAUNCHES)
    with torch.inference_mode():
        got = forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
        got_last = forward(model, {"tokens": torch.from_numpy(toks)}, tcfg,
                           last_only=True)
    assert (fa.LAUNCHES, ss.LAUNCHES) == before     # the CPU never launches
    _close(got.float(), want, compute, bound)
    _close(got_last.float(), want_last, compute, bound)

    steps = _tokens(rcfg, (2, DECODE), seed=2)
    rcache = RT.init_cache(rcfg, 2, DECODE + 4)
    tcache = init_cache(tcfg, 2, DECODE + 4, device="cpu")
    assert set(tcache) == set(rcache)
    ref_step = jax.jit(functools.partial(RT.decode_step, cfg=rcfg))
    for t in range(DECODE):
        rl, rcache = ref_step(tree, {"tokens": jnp.asarray(
            steps[:, t:t + 1])}, rcache)
        with torch.inference_mode():
            tl, tcache = decode_step(model, {"tokens": torch.from_numpy(
                steps[:, t:t + 1])}, tcache, tcfg)
        _close(tl.float(), rl, compute, bound)
    for name, leaf in rcache.items():
        if name == "len":
            assert tcache[name] == int(leaf) == DECODE
        else:
            _close(tcache[name].float(), leaf, compute, bound)


def test_dense_forward_takes_a_length_off_the_flash_tiles(compute):
    """S = 200 is no multiple of the TPU flash kernel's 128-row tiles; the
    reference's forward (a materialised softmax) serves it, and so does the
    port's, through the flash kernel's ragged last tile."""
    arch = "internlm2_1_8b"
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    tree = _tree(arch)
    model = from_reference(tcfg, tree, device="cpu")
    toks = _tokens(rcfg, (1, 200), seed=5)
    want = RT.forward(tree, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.inference_mode():
        got = forward(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(got.float(), want, compute, prefill_bound(tcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_token_by_token_decode(arch, compute):
    """The serving prefill (flash attention and the SSD scan) and the
    decode path (neither kernel) give the same next-token logits."""
    cfg = TC.smoke(arch)
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, SEQ), seed=4))
    cache = init_cache(cfg, 2, SEQ, device="cpu")
    with torch.inference_mode():
        pre = forward(model, {"tokens": toks}, cfg, last_only=True)
        for t in range(SEQ):
            logits, cache = decode_step(model, {"tokens": toks[:, t:t + 1]},
                                        cache, cfg)
    _close(pre[:, -1, :cfg.vocab].float(), logits[:, -1].float(), compute,
           prefill_bound(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_fresh_weights_have_the_reference_layout(arch):
    """init_params names and shapes every parameter as the carried
    reference tree does, and draws the reference's distributions."""
    cfg = TC.smoke(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = state_dict_from_reference(_tree(arch))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    w = got["layers.0.ssd.in_proj.w" if cfg.ssd else "layers.0.attn.wq.w"]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.1
    assert torch.equal(got["final_norm"], torch.ones(cfg.d_model))


def test_weight_carry_refuses_a_tree_that_does_not_fit():
    cfg = TC.smoke("internlm2_1_8b")
    tree = dict(_tree("internlm2_1_8b"))
    del tree["final_norm"]
    with pytest.raises(RuntimeError, match="final_norm"):
        from_reference(cfg, tree, device="cpu")


@pytest.mark.parametrize("change", [
    dict(family="moe", moe=object()), dict(attn_type="mla", mla=object()),
    dict(family="encdec", n_enc_layers=2), dict(family="vlm", n_patches=4)])
def test_families_of_later_slices_raise(change):
    cfg = dataclasses.replace(TC.smoke("internlm2_1_8b"), **change)
    with pytest.raises(NotImplementedError, match="A.11"):
        init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        init_cache(cfg, 1, 8, device="cpu")


def test_registry_serves_the_ported_configs_only():
    assert TC.ARCH_IDS == RC.ARCH_IDS and TC.SHAPES == RC.SHAPES
    for arch in ARCHS:
        for name in ("get", "smoke"):
            got, want = getattr(TC, name)(arch), getattr(RC, name)(arch)
            assert isinstance(got, ArchConfig)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(NotImplementedError, match="A.11"):
        TC.get("olmoe-1b-7b")
