"""The port's latent attention (``repro_torch.models.mla``) on the CPU
against the JAX package's ``mla_attention``, with the reference's weights
carried over: the prefill (no cache) and 8 cached decode steps, their
outputs and the latent cache ``ckv``, in float32 at rtol = atol = 1e-4, at
DeepSeek-V2-Lite's SMOKE geometry and at the serve driver's reduced one.
The prefill's core goes through the flash kernel's plain version with v
at its own width (a view of wider rows, as the model makes it, unpadded);
it equals the materialised core of the decode path (at 1e-5 in float32,
within the flash kernel's bf16 tolerance, 2e-2, in bf16, where only the
probabilities' rounding differs).  A v wider than the query's head dim,
and a full cache, are refused."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.train import reduced_config
from repro.models import mla as RMLA
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.build import PlanError
from repro_torch.models import mla as TMLA

F32_TOL = 1e-4
GEOMETRIES = {"smoke": RC.smoke("deepseek_v2_lite_16b").mla,
              "reduced": reduced_config(RC.get("deepseek_v2_lite_16b")).mla}
B, S, DECODE = 2, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    yield
    jax.clear_caches()


def _pair(cfg: RMLA.MLAConfig, seed: int = 0):
    tree = jax.tree.map(np.asarray, RMLA.mla_init(jax.random.key(seed), cfg))
    tcfg = TMLA.MLAConfig(**dataclasses.asdict(cfg))
    module = TMLA.MLA(tcfg, None, "cpu")
    flat = {name: (leaf["w"] if isinstance(leaf, dict) else leaf)
            for name, leaf in tree.items()}
    module.load_state_dict({(k if k == "kv_norm" else f"{k}.w"):
                            torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat.items()}, strict=True)
    return tree, tcfg, module


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_prefill_and_cached_decode_match_the_reference(geometry):
    cfg = GEOMETRIES[geometry]
    tree, tcfg, module = _pair(cfg)
    x = _x(cfg, (B, S), 1)
    want, _ = RMLA.mla_attention(tree, jnp.asarray(x), cfg)
    with torch.inference_mode():
        got, none = TMLA.mla_attention(module, torch.from_numpy(x), tcfg)
    assert none is None
    _close(got, want)

    width = cfg.kv_lora + cfg.qk_rope
    rcache = {"ckv": jnp.zeros((B, DECODE + 2, width), jnp.float32),
              "len": jnp.asarray(0, jnp.int32)}
    tcache = {"ckv": torch.zeros((B, DECODE + 2, width)), "len": 0}
    buf = tcache["ckv"]
    steps = _x(cfg, (B, DECODE), 2)
    ref_step = jax.jit(lambda p, x, pos, c: RMLA.mla_attention(
        p, x, cfg, positions=pos, cache=c))
    for t in range(DECODE):
        xt = steps[:, t:t + 1]
        pos = np.full((B, 1), t, np.int32)
        rout, rcache = ref_step(tree, jnp.asarray(xt), jnp.asarray(pos),
                                rcache)
        with torch.inference_mode():
            tout, tcache = TMLA.mla_attention(
                module, torch.from_numpy(xt), tcfg,
                positions=torch.from_numpy(pos), cache=tcache)
        _close(tout, rout)
        _close(tcache["ckv"], rcache["ckv"])
        assert tcache["len"] == int(rcache["len"]) == t + 1
    assert tcache["ckv"] is buf                  # updated in place


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_prefill_equals_the_decode_path(geometry):
    """Every position of one prefill equals the token-by-token decode's
    output at that position (the flash core against the materialised
    one, through the whole layer)."""
    cfg = GEOMETRIES[geometry]
    _, tcfg, module = _pair(cfg, seed=3)
    x = torch.from_numpy(_x(cfg, (B, S), 4))
    cache = {"ckv": torch.zeros((B, S, cfg.kv_lora + cfg.qk_rope)), "len": 0}
    with torch.inference_mode():
        want, _ = TMLA.mla_attention(module, x, tcfg)
        for t in range(S):
            pos = torch.full((B, 1), t)
            got, cache = TMLA.mla_attention(module, x[:, t:t + 1], tcfg,
                                            positions=pos, cache=cache)
            _close(got, want[:, t:t + 1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_the_unpadded_flash_core_equals_the_materialised_core(
        dtype, tol, monkeypatch):
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn((2, 40, 4, 24), generator=gen).to(dtype)
            for _ in range(2))
    # v as ``_expand_kv`` makes it: the last 16 columns of 40-wide rows
    v = torch.randn((2, 40, 4, 40), generator=gen).to(dtype)[..., 24:]
    pad = torch.nn.functional.pad
    seen = []
    real = fa.flash_attention_plain

    def plain(q_, k_, v_, causal=True):
        seen.append(tuple(v_.shape))
        return real(q_, k_, v_, causal)

    monkeypatch.setattr(fa, "flash_attention_plain", plain)
    before = fa.LAUNCHES
    got = TMLA._prefill_core(q, k, v)
    assert seen == [(2, 40, 4, 16)]              # v reached it unpadded
    # the padded core the port ran before, sliced back, agrees too
    padded = real(q, k, pad(v, (0, 8)), True)[..., :16]
    np.testing.assert_allclose(got.float().numpy(), padded.float().numpy(),
                               rtol=tol, atol=tol)
    want = ref.mha_ref(q, k, v, causal=True, q_offset=0)
    assert got.shape == (2, 40, 4, 16) and got.dtype == dtype
    assert fa.LAUNCHES == before                 # the CPU never launches
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def test_a_value_wider_than_the_query_is_refused():
    q = k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(PlanError, match="v_head"):
        TMLA._prefill_core(q, k, torch.zeros((1, 8, 2, 24)))


def test_a_full_latent_cache_is_refused():
    cfg = GEOMETRIES["smoke"]
    _, tcfg, module = _pair(cfg)
    cache = {"ckv": torch.zeros((1, 2, cfg.kv_lora + cfg.qk_rope)), "len": 2}
    with pytest.raises(ValueError, match="cache full"):
        TMLA.mla_attention(module, torch.zeros((1, 1, cfg.d_model)), tcfg,
                           positions=torch.full((1, 1), 2), cache=cache)
