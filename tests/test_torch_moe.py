"""The port's MoE (``repro_torch.models.moe``) on the CPU against the JAX
package's: the reference's ``moe_ffn`` runs under ``make_host_mesh()`` (a
model axis of 1, the served path), the port's ``moe_ffn`` on the same
numpy-made weights and inputs.  The chosen experts are compared exactly
first, so that a near-tie flipping in float32 shows as a flip, not as a
tolerance failure; the outputs then agree at rtol = atol = 1e-4 in
float32, and the dispatch equals the dense oracle ``moe_ffn_local`` of
either package at the reference's own 2e-3 (``tests/test_moe.py``).
The settings are ``tests/test_moe.py``'s: no drops at capacity factor 8,
forced drops behind a skewed router (the same rows dropped, the drop
count the reference's routing implies), shared experts; ``_capacity``
equals the reference's on a grid.  ``chip_smoke.capacity_oracle_ffn``,
the plain version of the dispatch's drops that the card holds the served
prefill against, equals the reference's dispatch in the same settings."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh
from repro.models import moe as RM
from repro.models.transformer import _moe_ffn_local
from repro_torch.models import moe as TM

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import capacity_oracle_ffn  # noqa: E402

F32_TOL = 1e-4
ORACLE_TOL = 2e-3       # tests/test_moe.py's dispatch-vs-oracle tolerance


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


def _port(cfg: RM.MoEConfig, tree) -> tuple:
    """The port's config and module holding the reference tree's
    weights."""
    tcfg = TM.MoEConfig(**dataclasses.asdict(cfg))
    module = TM.MoE(tcfg, None, "cpu")
    flat = {"router.w": tree["router"]["w"], "wi": tree["wi"],
            "wg": tree["wg"], "wo": tree["wo"]}
    for name, leaf in tree.get("shared", {}).items():
        flat[f"shared.{name}.w"] = leaf["w"]
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat.items()}, strict=True)
    return tcfg, module


def _setting(cfg, seed_p, seed_x, shape, scale=1.0, skew=False):
    p = RM.moe_init(jax.random.key(seed_p), cfg)
    if skew:                     # expert 0 or, on a tie, expert 1 first
        p["router"]["w"] = jnp.zeros_like(p["router"]["w"]).at[:, 0].set(10.0)
    x = jax.random.normal(jax.random.key(seed_x), shape, jnp.float32) * scale
    return jax.tree.map(np.asarray, p), np.asarray(x)


def _reference_experts(p, x, cfg) -> np.ndarray:
    """The reference's routing (``moe._dispatch_combine``'s first lines) on
    (T, d) tokens: the chosen experts in descending probability."""
    logits = jnp.asarray(x).astype(jnp.float32) @ jnp.asarray(
        p["router"]["w"]).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    cfg.top_k)[1])


def _run_both(cfg, p, x):
    """(reference y, port y, port drops) after checking that both route
    every token to the same experts in the same order."""
    tcfg, module = _port(cfg, p)
    xt = torch.from_numpy(x.copy())
    _, top_e = TM._route(xt.reshape(-1, cfg.d_model), module.router.w, tcfg)
    np.testing.assert_array_equal(top_e.numpy(), _reference_experts(
        p, x.reshape(-1, cfg.d_model), cfg))
    mesh = make_host_mesh()
    want = jax.jit(lambda p, x: RM.moe_ffn(p, x, cfg, mesh))(p, x)
    with torch.inference_mode(), TM.counting_drops() as drops:
        got = TM.moe_ffn(module, xt, tcfg)
    return (np.asarray(want), got.numpy(), TM.drop_counts(drops),
            (tcfg, module))


def test_dispatch_matches_the_reference_and_both_oracles_without_drops():
    cfg = RM.MoEConfig(d_model=32, n_experts=8, top_k=2, d_ff_expert=16,
                       capacity_factor=8.0)
    p, x = _setting(cfg, 0, 1, (2, 24, 32), scale=0.5)
    want, got, drops, (tcfg, module) = _run_both(cfg, p, x)
    assert drops == [0]
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    with torch.inference_mode(), TM.counting_drops() as oracle_drops:
        local = TM.moe_ffn_local(module, torch.from_numpy(x), tcfg).numpy()
    ref_local = np.asarray(jax.jit(lambda p, x: _moe_ffn_local(p, x, cfg))(
        p, x))
    np.testing.assert_allclose(local, ref_local, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, local, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    assert oracle_drops == []        # the oracle counts no dispatch


def test_drops_are_counted_only_inside_a_counting_block():
    cfg = TM.MoEConfig(d_model=16, n_experts=4, top_k=1, d_ff_expert=8,
                       capacity_factor=1.0)
    module = TM.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        TM.moe_ffn(module, x, cfg)                  # nobody counts
        assert TM._COUNTING is None
        with TM.counting_drops() as outer:
            TM.moe_ffn(module, x, cfg)
            with TM.counting_drops() as inner:
                TM.moe_ffn(module, x, cfg)
            TM.moe_ffn(module, x, cfg)
    assert len(inner) == 1 and len(outer) == 2
    assert TM.drop_counts(outer) == TM.drop_counts(inner) * 2
    assert TM._COUNTING is None


@pytest.mark.parametrize("top_k", [1, 2])
def test_forced_drops_drop_the_reference_slots(top_k):
    """Capacity factor 1 behind a router whose logits are 10 · sum(x) for
    expert 0 and 0 for the rest (ties, broken to the lower expert): the
    slots past each expert's capacity drop, in the reference's order (an
    expert's earliest tokens keep theirs), and the count is what the
    routing implies."""
    cfg = RM.MoEConfig(d_model=16, n_experts=4, top_k=top_k, d_ff_expert=8,
                       capacity_factor=1.0)
    p, x = _setting(cfg, 2, 3, (1, 64, 16), skew=True)
    want, got, drops, _ = _run_both(cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    cap = RM._capacity(64, cfg)
    te = _reference_experts(p, x[0], cfg)
    counts = np.bincount(te.reshape(-1), minlength=cfg.n_experts)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert drops == [dropped] and dropped > 0
    if top_k == 1:               # a dropped token has no routed output
        zero = np.abs(got[0]).sum(-1) <= 1e-7
        np.testing.assert_array_equal(zero, np.abs(want[0]).sum(-1) <= 1e-7)
        late = np.zeros(64, bool)     # past the first cap tokens of each
        for e in range(cfg.n_experts):
            late[np.flatnonzero(te[:, 0] == e)[cap:]] = True
        np.testing.assert_array_equal(zero, late)


def test_shared_experts_always_on():
    cfg = RM.MoEConfig(d_model=16, n_experts=4, top_k=1, d_ff_expert=8,
                       n_shared=1, d_ff_shared=16, capacity_factor=1.0)
    p, x = _setting(cfg, 4, 5, (1, 64, 16), skew=True)
    want, got, drops, _ = _run_both(cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert drops[0] > 0
    assert float(np.abs(got[0]).sum(-1).min()) > 0.0


def test_the_dispatch_in_bf16_rounds_as_the_reference():
    """Both packages in bf16 on the same bf16 tokens, routing equal: the
    outputs within the rounding of the four places the experts round,
    the three products and the combine (the dispatch buffer is a copy of
    bf16 rows): a relative L2 of sqrt(2 · 4) · 2^-8."""
    cfg = RM.MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32)
    p, x = _setting(cfg, 6, 7, (2, 32, 64))
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    tcfg, module = _port(cfg, p)
    mesh = make_host_mesh()
    want = np.asarray(RM.moe_ffn(p, jnp.asarray(xb).astype(jnp.bfloat16), cfg,
                                 mesh), np.float32)
    with torch.inference_mode():
        got = TM.moe_ffn(module, torch.from_numpy(xb).to(torch.bfloat16),
                         tcfg).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= np.sqrt(2 * 4) * 2.0 ** -8, rel


@pytest.mark.parametrize("top_k,n_shared", [(1, 0), (2, 0), (1, 1)])
def test_capacity_oracle_drops_the_reference_slots(top_k, n_shared):
    """The plain version of the dispatch (every expert on every token, a
    slot kept while its expert has taken fewer than C before it in slot
    order) equals the reference's dispatch behind the skewed router, and
    counts the slots the port's dispatch drops."""
    cfg = RM.MoEConfig(d_model=16, n_experts=4, top_k=top_k, d_ff_expert=8,
                       n_shared=n_shared, d_ff_shared=16 * n_shared,
                       capacity_factor=1.0)
    p, x = _setting(cfg, 2, 3, (1, 64, 16), skew=True)
    want, got, drops, (tcfg, module) = _run_both(cfg, p, x)
    with torch.inference_mode():
        y, dropped = capacity_oracle_ffn(module, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert [dropped] == drops and dropped > 0


@pytest.mark.parametrize("tokens", [1, 4, 7, 8, 64, 100, 2048, 4096])
@pytest.mark.parametrize("experts,top_k,factor", [
    (8, 2, 1.25), (64, 8, 1.25), (64, 6, 1.25), (4, 1, 1.0), (8, 2, 8.0)])
def test_capacity_equals_the_reference(tokens, experts, top_k, factor):
    cfg = RM.MoEConfig(d_model=16, n_experts=experts, top_k=top_k,
                       d_ff_expert=8, capacity_factor=factor)
    tcfg = TM.MoEConfig(**dataclasses.asdict(cfg))
    assert TM._capacity(tokens, tcfg) == RM._capacity(tokens, cfg)


def test_fresh_weights_have_the_reference_layout():
    cfg = RM.MoEConfig(d_model=32, n_experts=4, top_k=2, d_ff_expert=16,
                       n_shared=2, d_ff_shared=24)
    tcfg = TM.MoEConfig(**dataclasses.asdict(cfg))
    module = TM.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    tree = jax.tree.map(np.asarray, RM.moe_init(jax.random.key(0), cfg))
    _, carried = _port(cfg, tree)
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in carried.state_dict().items()}
    assert abs(float(module.wo.std()) * 16 ** 0.5 - 1.0) < 0.1
