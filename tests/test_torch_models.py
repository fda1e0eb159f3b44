"""The port's model side on the CPU against the JAX package, for the SMOKE
configs of the eight architectures it serves (dense ``internlm2_1_8b``,
``qwen15_4b`` (QKV bias), ``mistral_nemo_12b`` (at full size head_dim 128
over d_model 5120: wq and wo not square), ``phi3_medium_14b``; moe
``olmoe_1b_7b`` and ``deepseek_v2_lite_16b`` (latent attention, shared
experts, a first dense layer); ssm ``mamba2_780m``; hybrid
``zamba2_2_7b``), with the reference's weights carried by
``from_reference``: ``forward``, ``forward(last_only=True)`` and 8 cached
``decode_step``s (logits and every cache leaf).  For the MoE configs the
reference runs under ``mesh_context(make_ctx(make_host_mesh()))``, its
served path (the dispatch, not its dense oracle).

In float32 compute (both packages' ``COMPUTE_DTYPE`` patched inside the
test) the port agrees with the reference at rtol = atol = 1e-4.  In bf16 the
two round at different places (the flash kernel keeps the attention
probabilities in float32, the reference rounds them to bf16; sums run in
other orders), so they agree within ``launch.serve.prefill_bound``: a
relative L2 distance of 2 · sqrt(2 · roundings) · 2^-8, bf16's rounding at
six places a block (eight or nine an MoE block), added in quadrature over
the blocks, each passed on doubled by a sub-layer downstream.  The prefill's last-position logits equal the token-by-token
decode's within the same bounds (the MoE configs at capacity factor 8, as
the reference's own ``tests/test_moe.py`` runs its no-drop case: the
token path never drops, a prefill may), and the registry holds every
assigned config (the encdec and vlm families have their own file,
``tests/test_torch_families.py``).

The MoE routing is compared exactly first (``Routing``): in float32 both
sides choose the same experts for every token of every call.  In bf16 a
choice can flip where two experts' router logits lie within rounding of
each other.  The port takes the other side's choice for that call, so
that a flip shows as a flip and the logits are held to the rounding
bound, not to a discontinuity; ``chip_smoke.routing_flips`` (the rule the
card's checks apply) then asks that the two sides' router logits of every
token agree within the bound, and that every expert of a flipped token
lies within the two sides' logits' moves of its k-th logit."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.mesh import make_host_mesh
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.sharding import make_ctx, mesh_context
from repro_torch import configs as TC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import (decode_step, forward, from_reference,
                                init_cache, init_params)
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.convert import state_dict_from_reference
from repro_torch.models.transformer import ArchConfig

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (imposing_route, recording_route,  # noqa: E402
                        routing_flips)

ARCHS = ["internlm2_1_8b", "mamba2_780m", "zamba2_2_7b", "qwen15_4b",
         "mistral_nemo_12b", "phi3_medium_14b", "olmoe_1b_7b",
         "deepseek_v2_lite_16b"]
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


class Routing:
    """The experts each MoE dispatch call chooses, call by call, with the
    router logits that chose them.  ``reference`` collects the JAX
    package's (its ``_dispatch_combine`` wrapped to report them through
    ``jax.debug.callback``); ``impose`` queues choices that the port's
    ``_route`` then takes in call order (``chip_smoke.imposing_route``,
    which keeps what it saw in ``seen``; ``imposed`` counts the calls);
    with nothing queued the port routes as it does and ``recorded`` keeps
    its choices (``chip_smoke.recording_route``)."""

    def __init__(self, monkeypatch):
        self.reference, self.impose, self.seen, self.recorded = [], [], [], []
        self.imposed = 0
        real_dc, real_route = RM._dispatch_combine, TM._route
        imposing = imposing_route(real_route, self.impose, self.seen)
        recording = recording_route(real_route, self.recorded)

        def dispatch_combine(x, router_w, *args, cfg, model_axis):
            logits = x.astype(jnp.float32) @ router_w.astype(jnp.float32)
            top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)[1]
            jax.debug.callback(lambda e, z: self.reference.append(
                (np.asarray(e), np.asarray(z))), top_e, logits)
            return real_dc(x, router_w, *args, cfg=cfg, model_axis=model_axis)

        def route(x, router_w, cfg):
            if not self.impose:
                return recording(x, router_w, cfg)
            self.imposed += 1
            return imposing(x, router_w, cfg)

        monkeypatch.setattr(RM, "_dispatch_combine", dispatch_combine)
        monkeypatch.setattr(TM, "_route", route)

    def take_reference(self) -> None:
        """Queue every collected reference choice for the port."""
        jax.effects_barrier()
        self.impose += [(torch.from_numpy(e.astype(np.int64)),
                         torch.from_numpy(np.array(z, np.float32)))
                        for e, z in self.reference]
        self.reference.clear()

    def check_flips(self, compute: str, bound: float) -> int:
        """None in float32; in bf16 only as ``routing_flips`` allows, the
        router logits within ``bound``.  Returns the flips and forgets
        what it saw."""
        assert not self.impose, "a queued choice was never taken"
        f = routing_flips(self.seen, F32_TOL if compute == "f32" else bound)
        if compute == "f32":
            assert f["flips"] == 0, f"float32 routing flipped: {f}"
        assert f["untied"] == 0 and f["drifted"] == 0, f
        self.seen.clear()
        self.recorded.clear()
        return f["flips"]


@pytest.fixture
def routing(monkeypatch):
    return Routing(monkeypatch)


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


def _served(fn):
    """``fn`` under the reference's served mesh context."""
    @functools.wraps(fn)
    def call(*args, **kw):
        with mesh_context(make_ctx(make_host_mesh())):
            return fn(*args, **kw)
    return call


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_the_reference(arch, compute, routing):
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    tree = _tree(arch)
    model = from_reference(tcfg, tree, device="cpu")
    bound = prefill_bound(tcfg)
    toks = _tokens(rcfg, (2, SEQ))
    ref_forward = _served(RT.forward)
    before = (fa.LAUNCHES, ss.LAUNCHES)
    for last_only in (False, True):
        want = ref_forward(tree, {"tokens": jnp.asarray(toks)}, rcfg,
                           last_only=last_only)
        routing.take_reference()
        with torch.inference_mode():
            got = forward(model, {"tokens": torch.from_numpy(toks)}, tcfg,
                          last_only=last_only)
        routing.check_flips(compute, bound)
        _close(got.float(), want, compute, bound)
    assert (fa.LAUNCHES, ss.LAUNCHES) == before     # the CPU never launches
    n_moe = tcfg.n_layers - tcfg.first_dense if tcfg.moe is not None else 0
    assert routing.imposed == 2 * n_moe             # both forwards routed

    steps = _tokens(rcfg, (2, DECODE), seed=2)
    rcache = RT.init_cache(rcfg, 2, DECODE + 4)
    tcache = init_cache(tcfg, 2, DECODE + 4, device="cpu")
    assert set(tcache) == set(rcache)
    ref_step = jax.jit(_served(functools.partial(RT.decode_step, cfg=rcfg)))
    for t in range(DECODE):
        rl, rcache = ref_step(tree, {"tokens": jnp.asarray(
            steps[:, t:t + 1])}, rcache)
        routing.take_reference()
        with torch.inference_mode():
            tl, tcache = decode_step(model, {"tokens": torch.from_numpy(
                steps[:, t:t + 1])}, tcache, tcfg)
        routing.check_flips(compute, bound)
        _close(tl.float(), rl, compute, bound)
    assert routing.imposed == (2 + DECODE) * n_moe
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
def test_prefill_matches_token_by_token_decode(arch, compute, routing):
    """The serving prefill (flash attention and the SSD scan) and the
    decode path (neither kernel) give the same next-token logits; the MoE
    configs run at capacity factor 8 (no slot drops), and the decode takes
    the prefill's choices where a bf16 tie flipped."""
    cfg = TC.smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    bound = prefill_bound(cfg)
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, SEQ), seed=4))
    cache = init_cache(cfg, 2, SEQ, device="cpu")
    with torch.inference_mode(), TM.counting_drops() as drops:
        pre = forward(model, {"tokens": toks}, cfg, last_only=True)
        chosen = [tuple(r.reshape(2, SEQ, -1) for r in entry)
                  for entry in routing.recorded]
        routing.impose += [(e[:, t], z[:, t]) for t in range(SEQ)
                           for e, z in chosen]
        for t in range(SEQ):
            logits, cache = decode_step(model, {"tokens": toks[:, t:t + 1]},
                                        cache, cfg)
    assert routing.imposed == len(chosen) * SEQ
    routing.check_flips(compute, bound)
    assert sum(TM.drop_counts(drops)) == 0
    _close(pre[:, -1, :cfg.vocab].float(), logits[:, -1].float(), compute,
           bound)


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


def test_weight_carry_refuses_an_moe_tree_without_its_dense_layers():
    cfg = TC.smoke("deepseek_v2_lite_16b")
    tree = dict(_tree("deepseek_v2_lite_16b"))
    del tree["dense_layers"]
    with pytest.raises(RuntimeError, match="dense_layers"):
        from_reference(cfg, tree, device="cpu")


def test_expert_leaves_split_on_the_layer_axis():
    """The reference's (L, E, d, f) expert leaves land as (E, d, f) per
    layer, the dense layers' under their own names."""
    cfg = TC.smoke("deepseek_v2_lite_16b")
    tree = _tree("deepseek_v2_lite_16b")
    model = from_reference(cfg, tree, device="cpu")
    for i in range(cfg.n_layers - cfg.first_dense):
        assert torch.equal(model.layers[i].moe.wi, torch.tensor(
            tree["layers"]["moe"]["wi"][i]))
    assert torch.equal(model.dense_layers[0].mlp.wo.w, torch.tensor(
        tree["dense_layers"]["mlp"]["wo"]["w"][0]))


def test_registry_serves_the_ported_configs_only():
    """The port's registry holds all ten architectures
    (``tests/test_torch_families.py`` runs the encdec and vlm ones)."""
    assert TC.ARCH_IDS == RC.ARCH_IDS and TC.SHAPES == RC.SHAPES
    assert list(TC.PORTED) == TC.ARCH_IDS
    for arch in TC.ARCH_IDS:
        for name in ("get", "smoke"):
            got, want = getattr(TC, name)(arch), getattr(RC, name)(arch)
            assert isinstance(got, ArchConfig)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get("gpt_2")
