"""The port's training path on the CPU against the JAX package, on the same
seeded numpy inputs, with the reference's weights carried by
``from_reference`` and gradient trees mapped back by ``to_reference``.

* the RMS norm's hand-written backward and the flash Function's gradients
  against ``jax.grad`` of the reference's custom VJPs (``ops.flash_attention``
  in interpret mode, as ``tests/test_flash_attention.py`` runs it), the SSD
  Function's against autograd through its own recurrence;
* ``loss_fn`` and its gradients on the SMOKE configs of every family the port
  serves (dense with and without QKV bias, ssm, hybrid, moe with GQA and with
  latent attention), with and without remat;
* three ``make_train_step`` steps (losses, grad norms, parameters and
  AdamW's ``m``/``v``/``step``), ``cosine_schedule``, ``accumulate_grads``
  with 2 microbatches and ``quantize_int8``;
* ``StragglerPolicy``/``HeartbeatMonitor`` case for case with
  ``tests/test_checkpoint_ft.py``, ``resume_latest``, the checkpoint layout
  of a model against the reference store's, a resume held against the
  port's own uninterrupted run, and ``launch/train.py --reduced --device
  cpu`` end to end.

Tolerances.  In float32 (both packages' ``COMPUTE_DTYPE`` patched) the loss
agrees within 1e-5 relative and every gradient leaf within 1e-4 relative L2
(the two sum in other orders; observed ≤ 3e-6).  After three AdamW steps the
parameters, ``m`` and ``v`` agree within 1e-3 relative L2 per leaf (observed
≤ 1.3e-4): AdamW scales each element's step by its own gradient's size, so
an element whose gradient is small against its leaf's carries its larger
relative rounding into a full-size step (a leaf that starts at zero, as a
bias, is nothing but steps), and the second and third gradients are taken
at parameters that already differ by that.  In bf16
the two packages round at different places, as the serving tests establish:
the loss within ``prefill_bound`` (2 · sqrt(2 · roundings) · 2^-8, the
logits' bound) relative, and each gradient leaf within sqrt(2) times it
(the backward rounds at as many places again, independently, so the errors
add in quadrature).  The MoE configs are held in float32 only: in bf16 their
routing can flip where two experts' logits tie within rounding
(``tests/test_torch_models.py`` holds those flips).  The flash Function's
bf16 gradients are held within 2 · 2^-8: the reference rounds each key
block's logits to bf16 before the exponent (relative 2^-9 on the
probabilities, for logits of order one) and both round the gradients to
bf16 (2^-9 each)."""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels import ops as rops
from repro.launch.mesh import make_host_mesh
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.sharding import make_ctx, mesh_context
from repro.train import checkpoint as rckpt
from repro.train import ft as rft
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import configs as TC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import (from_reference, init_params, load_reference,
                                loss_fn, reference_like, to_reference)
from repro_torch.models import layers as TL
from repro_torch.models.ssd import chunk_scan
from repro_torch.train import (AdamW, CheckpointStore, HeartbeatMonitor,
                               StragglerPolicy, accumulate_grads,
                               cosine_schedule, ef_init, make_eval_step,
                               make_train_step, quantize_int8, resume_latest)

ARCHS = ["internlm2_1_8b", "mamba2_780m", "zamba2_2_7b", "qwen15_4b",
         "mistral_nemo_12b", "phi3_medium_14b", "olmoe_1b_7b",
         "deepseek_v2_lite_16b"]
TRAIN_ARCHS = ["internlm2_1_8b", "mamba2_780m", "zamba2_2_7b", "olmoe_1b_7b",
               "deepseek_v2_lite_16b"]     # one a family, latent attention
LOSS_F32 = 1e-5
GRAD_F32 = 1e-4
STEPS_F32 = 1e-3    # parameters and moments after three AdamW steps
FLASH_BF16 = 2 * 2.0 ** -8
SEQ = 32            # a multiple of every SMOKE chunk (16)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close_trees(got: dict, want, tol: float, what: str) -> float:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    worst = 0.0
    for path in want:
        r = _rel(_host(got[path]), _host(want[path]))
        assert r <= tol, (what, path, r, tol)
        worst = max(worst, r)
    return worst


@functools.lru_cache(maxsize=None)
def _tree(arch):
    cfg = RC.smoke(arch)
    return jax.tree.map(np.asarray, RT.init_params(cfg, jax.random.key(0)))


def _batch(vocab, b=2, s=SEQ, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _served(fn):
    """``fn`` under the reference's host mesh context (its train step runs
    inside ``mesh_context(ctx)``; the MoE dispatch needs it)."""
    @functools.wraps(fn)
    def call(*args, **kw):
        with mesh_context(make_ctx(make_host_mesh())):
            return fn(*args, **kw)
    return call


def _port_grads(model, cfg, batch):
    named = dict(model.named_parameters())
    loss = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), to_reference(model, dict(zip(named, grads)))


# ------------------------------------------------------------ rms norm --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_reference_vjp(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((4, 8, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(RL.rms_norm, jnp.asarray(scale),
                     jnp.asarray(x).astype(jdt))
    gs, gx = vjp(jnp.asarray(dy).astype(jdt))
    ts = torch.tensor(scale, requires_grad=True)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    out = TL.rms_norm(ts, tx)
    out.backward(torch.tensor(dy).to(tdt))
    assert out.dtype == tdt and tx.grad.dtype == tdt
    assert ts.grad.dtype == torch.float32
    if dtype == "bfloat16":     # the same roundings in the same order
        np.testing.assert_array_equal(_host(out), _host(y))
        np.testing.assert_array_equal(_host(tx.grad), _host(gx))
        assert _rel(ts.grad, gs) <= 1e-6
    else:
        np.testing.assert_allclose(_host(out), _host(y), rtol=1e-6, atol=1e-6)
        assert _rel(tx.grad, gx) <= GRAD_F32 and _rel(ts.grad, gs) <= GRAD_F32


def test_rms_norm_forward_unchanged_under_inference_mode():
    x = torch.randn(3, 5, 32, generator=torch.Generator().manual_seed(0))
    s = torch.ones(32)
    with torch.inference_mode():
        y = TL.rms_norm(s, x.bfloat16())
    xb = x.bfloat16()
    inv = torch.rsqrt(xb.float().square().mean(-1, keepdim=True) + 1e-6)
    assert torch.equal(y, xb * inv.to(xb.dtype) * s.to(xb.dtype))


# --------------------------------------------------------------- flash --
@pytest.mark.parametrize("b,s,h,hkv,dh,causal,dtype", [
    (1, 256, 4, 2, 128, True, "float32"),
    (1, 256, 4, 2, 128, False, "float32"),
    (1, 384, 6, 2, 64, True, "float32"),       # 384: three 128-row tiles
    (2, 256, 4, 1, 64, True, "bfloat16"),      # MQA, bf16
])
def test_flash_gradients_match_reference_vjp(b, s, h, hkv, dh, causal, dtype):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, s, h, dh), (b, s, hkv, dh),
                                 (b, s, hkv, dh), (b, s, h, dh)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, c, e: rops.flash_attention(a, c, e, causal,
                                                            True),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    tq, tk, tv = (torch.tensor(t).to(tdt).requires_grad_(True)
                  for t in (q, k, v))
    before = fa.LAUNCHES
    o = ops.flash_attention(tq, tk, tv, causal)
    o.backward(torch.tensor(do).to(tdt))
    assert fa.LAUNCHES == before            # the CPU runs the plain version
    tol = GRAD_F32 if dtype == "float32" else FLASH_BF16
    assert _rel(_host(o), _host(out)) <= tol
    for got, ref in zip((tq, tk, tv), want):
        assert got.grad.dtype == tdt
        assert _rel(_host(got.grad), _host(ref)) <= tol


@pytest.mark.parametrize("s", [200, 700, 1100])
def test_flash_gradients_at_ragged_lengths_match_autograd(s):
    """Lengths off the 512-key blocks (the last block ragged) and off the
    kernel's tiles: the Function's backward against autograd through the
    plain version's materialised softmax."""
    g = torch.Generator().manual_seed(s)
    q = torch.randn(1, s, 4, 32, generator=g, requires_grad=True)
    k = torch.randn(1, s, 2, 32, generator=g, requires_grad=True)
    v = torch.randn(1, s, 2, 32, generator=g, requires_grad=True)
    do = torch.randn(1, s, 4, 32, generator=g)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, True), (q, k, v),
                              do)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, True),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_F32


# ----------------------------------------------------------------- ssd --
def _ssd_inputs(b, l, h, p, n, dt_scale, seed):
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(b, l, h, p, generator=g)
    bm = torch.randn(b, l, n, generator=g) / n ** 0.5
    cm = torch.randn(b, l, n, generator=g) / n ** 0.5
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=g)) \
        * dt_scale
    a = -torch.exp(0.5 * torch.randn(h, generator=g))
    return [t.requires_grad_(True) for t in (xs, bm, cm, dt, a)]


@pytest.mark.parametrize("chunk,l", [(16, 64), (64, 64), (32, 96)])
def test_ssd_gradients_match_autograd_through_the_plain_scan(chunk, l):
    """The Function's backward (the recurrence recomputed through
    ``chunk_step``) against autograd through the kernel's plain version,
    the final state's cotangent included."""
    inputs = _ssd_inputs(2, l, 3, 8, 16, 1.0, chunk)
    g = torch.Generator().manual_seed(1)
    dy = torch.randn(2, l, 3, 8, generator=g)
    dstate = torch.randn(2, 3, 8, 16, generator=g)
    before = ss.LAUNCHES
    y, state = ops.ssd_scan(*inputs, chunk)
    got = torch.autograd.grad((y, state), inputs, (dy, dstate))
    assert ss.LAUNCHES == before
    y2, state2 = ss.ssd_scan_plain(*inputs, chunk)
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want = torch.autograd.grad((y2, state2), inputs, (dy, dstate))
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_F32
    # the recurrence itself gives the forward's values
    y3, state3 = chunk_scan(*inputs, chunk)
    assert _rel(y3.detach(), y.detach()) <= 1e-5
    assert _rel(state3.detach(), state.detach()) <= 1e-5


def test_ssd_gradients_stay_finite_where_the_decay_overflows():
    """A chunk whose cumulative decay spans more than exp's float32 range:
    masking the decay matrix after ``exp`` would send 0 · inf = NaN into
    the gradient; ``chunk_step`` masks the exponent."""
    inputs = _ssd_inputs(1, 64, 2, 8, 16, 20.0, 3)
    y, _ = ops.ssd_scan(*inputs, 64)
    grads = torch.autograd.grad(y.square().sum(), inputs)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    assert all(float(t.abs().sum()) > 0 for t in grads)


# ---------------------------------------------------- loss and gradients --
@pytest.mark.parametrize("arch,remat", [(a, False) for a in ARCHS]
                         + [(a, True) for a in TRAIN_ARCHS])
def test_loss_and_grads_match_reference_f32(arch, remat, f32):
    rcfg = dataclasses.replace(RC.smoke(arch), remat=remat)
    tcfg = dataclasses.replace(TC.smoke(arch), remat=remat)
    tree = _tree(arch)
    batch = _batch(rcfg.vocab)
    want_loss, want = _served(jax.value_and_grad(RT.loss_fn))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    model = from_reference(tcfg, tree, device="cpu").requires_grad_(True)
    loss, grads = _port_grads(model, tcfg, batch)
    assert abs(loss - float(want_loss)) <= LOSS_F32 * abs(float(want_loss))
    _close_trees(grads, want, GRAD_F32, arch)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen15_4b",
                                  "mamba2_780m", "zamba2_2_7b"])
def test_loss_and_grads_match_reference_bf16(arch):
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    bound = prefill_bound(tcfg)
    tree = _tree(arch)
    batch = _batch(rcfg.vocab)
    want_loss, want = _served(jax.value_and_grad(RT.loss_fn))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    model = from_reference(tcfg, tree, device="cpu").requires_grad_(True)
    loss, grads = _port_grads(model, tcfg, batch)
    assert abs(loss - float(want_loss)) <= bound * abs(float(want_loss))
    _close_trees(grads, want, math.sqrt(2) * bound, arch)


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each block in the backward: the same
    gradients, bit for bit, on the CPU."""
    cfg = TC.smoke("zamba2_2_7b")
    batch = _batch(cfg.vocab)
    out = []
    for remat in (False, True):
        model = from_reference(dataclasses.replace(cfg, remat=remat),
                               _tree("zamba2_2_7b"), device="cpu")
        out.append(_port_grads(model.requires_grad_(True),
                               dataclasses.replace(cfg, remat=remat), batch))
    assert out[0][0] == out[1][0]
    for (p, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_to_reference_inverts_the_carry():
    for arch in ("deepseek_v2_lite_16b", "zamba2_2_7b"):
        tree = _tree(arch)
        back = to_reference(from_reference(TC.smoke(arch), tree,
                                           device="cpu"))
        assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(tree)]
        for (p, a), (_, b) in zip(_leaves(back), _leaves(tree)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=p)
        like = reference_like(from_reference(TC.smoke(arch), tree,
                                             device="cpu"))
        for (_, a), (_, b) in zip(_leaves(like), _leaves(tree)):
            assert a.device.type == "meta" and tuple(a.shape) == b.shape


# ------------------------------------------------------------ optimizer --
def test_cosine_schedule_matches_reference():
    want = ropt.cosine_schedule(3e-4, warmup=10, total=40)
    got = cosine_schedule(3e-4, warmup=10, total=40)
    for step in range(0, 45):
        w = float(want(jnp.asarray(step, jnp.int32)))
        g = float(got(torch.tensor(step, dtype=torch.int32)))
        assert abs(g - w) <= 1e-6 * 3e-4, (step, g, w)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_three_train_steps_match_reference(arch, f32):
    rcfg, tcfg = RC.smoke(arch), TC.smoke(arch)
    tree = _tree(arch)
    ctx = make_ctx(make_host_mesh())
    ropt_ = ropt.AdamW(lr=ropt.cosine_schedule(1e-2, warmup=2, total=3))
    topt = AdamW(lr=cosine_schedule(1e-2, warmup=2, total=3))
    rstep = jax.jit(rts.make_train_step(rcfg, ctx, ropt_))
    tstep = make_train_step(tcfg, topt)
    rparams, rstate = jax.tree.map(jnp.asarray, tree), ropt_.init(tree)
    model = from_reference(tcfg, tree, device="cpu").requires_grad_(True)
    tstate = topt.init(model)
    for i in range(3):
        batch = _batch(rcfg.vocab, seed=10 + i)
        rparams, rstate, rm = rstep(rparams, rstate,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        model, tstate, tm = tstep(model, tstate, batch)
        assert int(tm["step"]) == int(rm["step"]) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(rm[key])) <= \
                LOSS_F32 * abs(float(rm[key])), (i, key)
    assert int(tstate.step) == int(rstate.step) == 3
    _close_trees(to_reference(model), rparams, STEPS_F32, "params")
    _close_trees(to_reference(model, tstate.m), rstate.m, STEPS_F32, "m")
    _close_trees(to_reference(model, tstate.v), rstate.v, STEPS_F32, "v")


def test_adamw_first_step_by_hand():
    """One update on one leaf against the reference's formula written out:
    clip to norm 1, bias-corrected moments, decay on the leaf."""
    opt = AdamW(lr=0.1, weight_decay=0.1, clip_norm=1.0)
    p = torch.tensor([1.0, -2.0, 3.0])
    g = torch.tensor([3.0, 0.0, 4.0])                 # norm 5 -> scale 0.2
    params = {"w": p.clone()}
    state = opt.init(params)
    _, state, gnorm = opt.update({"w": g}, state, params)
    gs = g * 0.2
    m, v = 0.1 * gs, 0.05 * gs * gs
    mh, vh = m / 0.1, v / (1 - 0.95)
    want = p - 0.1 * (mh / (vh.sqrt() + 1e-8) + 0.1 * p)
    assert float(gnorm) == 5.0 and int(state.step) == 1
    assert torch.allclose(params["w"], want, rtol=1e-6, atol=1e-7)
    assert torch.allclose(state.m["w"], m) and torch.allclose(state.v["w"], v)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_780m"])
def test_accumulate_grads_two_microbatches_matches_reference(arch, f32):
    rcfg = dataclasses.replace(RC.smoke(arch), microbatches=2)
    tcfg = dataclasses.replace(TC.smoke(arch), microbatches=2)
    tree = _tree(arch)
    batch = _batch(rcfg.vocab, b=4, seed=3)
    want_loss, want = _served(rts.accumulate_grads)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    model = from_reference(tcfg, tree, device="cpu").requires_grad_(True)
    loss, grads = accumulate_grads(model, batch, tcfg)
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_F32 * abs(float(want_loss))
    _close_trees(to_reference(model, grads), want, GRAD_F32, arch)
    # the mean of the two halves' losses is the whole batch's loss
    whole = make_eval_step(tcfg)(model, batch)
    assert abs(float(whole) - float(loss)) <= LOSS_F32 * float(loss)


def test_train_step_refuses_frozen_parameters():
    cfg = TC.smoke("internlm2_1_8b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg)
    with pytest.raises(ValueError, match="trainable=True"):
        step(model, AdamW().init(model), _batch(cfg.vocab))


def test_grad_compress_is_the_plain_step_on_one_card():
    cfg = TC.smoke("internlm2_1_8b")
    out = []
    for compress in (False, True):
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        opt = AdamW()
        model, _, m = make_train_step(cfg, opt, grad_compress=compress)(
            model, opt.init(model), _batch(cfg.vocab))
        out.append((float(m["loss"]), to_reference(model)))
    assert out[0][0] == out[1][0]
    for (_, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10 ** seed).astype(np.float32)
    x[::97] = np.round(x[::97])                      # ties at .5 of a step
    rq, rscale = rts.quantize_int8(jnp.asarray(x))
    tq, tscale = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert abs(float(tscale) - float(rscale)) <= 1e-7 * float(rscale)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    ef = ef_init({"w": torch.zeros(3, 4)}, 2)
    assert ef["w"].shape == (2, 3, 4) and ef["w"].dtype == torch.float32


def test_quantize_int8_error_feedback_converges():
    """``tests/test_checkpoint_ft.py``'s error-feedback case."""
    rng = np.random.default_rng(0)
    g_true = rng.standard_normal(512).astype(np.float32)
    ef = np.zeros_like(g_true)
    acc_q, acc_t = np.zeros_like(g_true), np.zeros_like(g_true)
    for _ in range(200):
        target = torch.from_numpy(g_true + ef)
        q, scale = quantize_int8(target)
        deq = q.numpy().astype(np.float32) * float(scale)
        ef = target.numpy() - deq
        acc_q += deq
        acc_t += g_true
    assert np.abs(acc_q - acc_t).max() / np.abs(acc_t).max() < 1e-2


# ------------------------------------------------------ fault tolerance --
def _policy_case(cls):
    sp = cls(n_hosts=8, deadline_factor=2.0, max_drop_frac=0.25)
    for _ in range(5):
        for h in range(8):
            sp.observe(h, 1.0 if h != 3 else 10.0)   # host 3 is slow
    sp2 = cls(n_hosts=8, deadline_factor=1.5, max_drop_frac=0.25)
    for h in range(8):
        sp2.observe(h, 10.0 if h < 4 else 1.0)
    sp3 = cls(n_hosts=4)
    return [sp.active_hosts(), sp2.active_hosts(), sp3.active_hosts(),
            sp.ewma]


def test_straggler_policy_matches_reference():
    got = _policy_case(StragglerPolicy)
    want = _policy_case(rft.StragglerPolicy)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 3 not in got[0] and len(got[0]) == 7 and len(got[1]) >= 6


def test_heartbeat_monitor_matches_reference():
    out = []
    for cls in (HeartbeatMonitor, rft.HeartbeatMonitor):
        hm = cls(n_hosts=4, timeout_s=5.0)
        now = 1000.0
        for h in range(4):
            hm.beat(h, t=now)
        healthy = hm.healthy(now + 1)
        hm.beat(0, t=now + 10)
        out.append((healthy, hm.dead_hosts(now + 10).tolist(),
                    hm.healthy(now + 10)))
    assert out[0] == out[1] == (True, [1, 2, 3], False)


def test_resume_latest_picks_max_step(tmp_path):
    store = CheckpointStore(str(tmp_path / "ckpt"), shard_rows=64)
    t = {"w": np.ones((8, 4), np.float32), "b": np.zeros(4, np.float32)}
    assert resume_latest(store) == (None, None, {})
    store.save(step=1, tree=t, meta={"cursor": 100})
    v2 = store.save(step=7, tree={"w": t["w"] * 2, "b": t["b"]},
                    meta={"cursor": 700})
    vid, tree, meta = resume_latest(store, device="cpu", treedef_like=t)
    assert vid == v2 and meta["cursor"] == 700
    assert torch.equal(tree["w"], torch.full((8, 4), 2.0))


def test_model_checkpoint_layout_matches_reference(tmp_path):
    """The trainer's checkpoint of a model (``to_reference``'s tree) and the
    reference's checkpoint of the same weights write the same manifest
    layout and rows, and restore into the same model."""
    arch = "deepseek_v2_lite_16b"
    tree = _tree(arch)
    model = from_reference(TC.smoke(arch), tree, device="cpu")
    port = CheckpointStore(str(tmp_path / "port"), shard_rows=256)
    ref = rckpt.CheckpointStore(str(tmp_path / "ref"), shard_rows=256)
    pv = port.save(step=3, tree=to_reference(model, host=False),
                   meta={"cursor": 3})
    rv = ref.save(step=3, tree=tree, meta={"cursor": 3})
    assert port.manifest["versions"][str(pv)]["layout"] == \
        ref.manifest["versions"][str(rv)]["layout"]
    np.testing.assert_array_equal(port.cvd.checkout(pv), ref.cvd.checkout(rv))
    fresh = init_params(TC.smoke(arch), torch.Generator().manual_seed(9),
                        "cpu")
    _, back, meta = resume_latest(port, device="cpu",
                                  treedef_like=reference_like(fresh))
    load_reference(fresh, back)
    assert meta == {"cursor": 3}
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)


# -------------------------------------------------------------- resume --
def _corpus(cfg):
    return ttrain.corpus(cfg, seq=32, seed=0, device="cpu", log=lambda s: None)


def test_resume_replays_no_batch_and_restores_bit_exact(tmp_path):
    """An interrupted run (3 steps, a checkpoint, the trainer dropped,
    ``restore_or_init`` from the store, 3 more steps) against the port's own
    uninterrupted 6 steps: the restored parameters equal the saved ones bit
    for bit, the resumed batches are the uninterrupted run's steps 3-5, the
    first three losses are equal, and the resumed run's are finite (its
    AdamW starts fresh, as the reference's does)."""
    cfg = ttrain.reduced_config(TC.get("internlm2_1_8b"))
    ds, vid = _corpus(cfg)
    quiet = dict(seed=0, batch=4, steps=6, log=lambda s: None)
    model, _, _ = ttrain.restore_or_init(
        cfg, CheckpointStore(str(tmp_path / "none")), seed=0, device="cpu",
        log=lambda s: None)
    whole = ttrain.train(cfg, model, ds, vid, store=None, start=0,
                         parent_vid=None, **quiet)
    store = CheckpointStore(str(tmp_path / "ckpt"), shard_rows=1 << 12)
    model, start, parent = ttrain.restore_or_init(cfg, store, seed=0,
                                                  device="cpu",
                                                  log=lambda s: None)
    first = ttrain.train(cfg, model, ds, vid, store=store, start=start,
                         parent_vid=parent, ckpt_every=3, preempt_after=3,
                         **quiet)
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    model, start, parent = ttrain.restore_or_init(cfg, store, seed=0,
                                                  device="cpu",
                                                  log=lambda s: None)
    assert (start, parent) == (3, first["checkpoints"][0]["vid"])
    for n, p in model.named_parameters():
        assert torch.equal(p, saved[n]), n
    second = ttrain.train(cfg, model, ds, vid, store=store, start=start,
                          parent_vid=parent, ckpt_every=3, **quiet)
    assert second["start"] == 3 and len(second["losses"]) == 3
    assert first["losses"] == whole["losses"][:3]
    for a, b in zip(first["tokens"] + second["tokens"], whole["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(second["losses"] + second["grad_norms"]))
    assert store.lineage(second["checkpoints"][0]["vid"]) == [parent]


def test_launcher_trains_and_resumes_end_to_end(tmp_path, capsys):
    args = ["--arch", "mamba2_780m", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "4", "--seq", "64", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--microbatches", "2"]
    assert ttrain.main(args + ["--preempt-after", "2"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ttrain.main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    second = json.loads(out[-1])
    assert any("resumed from checkpoint v0 at step 2" in line for line in out)
    assert (first["start"], len(first["losses"])) == (0, 2)
    assert (second["start"], len(second["losses"])) == (2, 2)
    assert second["checkpoints"] == [1] and second["device"] == "cpu"
    assert all(np.isfinite(first["losses"] + second["losses"]))
    assert second["launches"] == {"gather_row_tiles": 0,
                                  "flash_attention": 0, "ssd_scan": 0}


def test_launcher_refuses_a_multi_card_mesh(tmp_path, monkeypatch, capsys):
    """The multi-pod mesh needs its 512 ranks: on one it raises
    ``PlanError`` and starts no group; with its shape patched to one rank
    (1, 1, 1) ``--mesh multi --grad-compress`` trains on it through the
    compressed step, its losses ``make_train_step``'s on that mesh."""
    from repro_torch.kernels.build import PlanError
    from repro_torch.launch import mesh as M
    from repro_torch.models.transformer import param_specs
    from repro_torch.sharding import distribute, make_ctx
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--reduced", "--device", "cpu", "--mesh", "multi",
            "--grad-compress", "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(PlanError, match="needs 512 ranks"):
        ttrain.main(argv)
    assert not torch.distributed.is_initialized()
    monkeypatch.setitem(M.PRODUCTION, "multi",
                        ((1, 1, 1), ("pod", "data", "model")))
    capsys.readouterr()
    ttrain.main(argv)
    losses = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "losses"]
    assert not torch.distributed.is_initialized()
    cfg = ttrain.reduced_config(TC.get("internlm2_1_8b"))
    ds, vid = ttrain.corpus(cfg, seq=32, seed=0, device="cpu",
                            log=ttrain._quiet)
    ctx = make_ctx(M.make_production_mesh(multi_pod=True, device="cpu"))
    try:
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
        distribute(model, param_specs(cfg), ctx.mesh)
        opt = AdamW(lr=cosine_schedule(3e-4, warmup=10, total=2))
        state, ef = opt.init(model), ef_init(model, 1, ctx)
        step = make_train_step(cfg, opt, grad_compress=True, ctx=ctx)
        want = []
        for b in ds.batches(vid=vid, global_batch=2, seed=1, start_step=0,
                            n_steps=2):
            model, state, ef, m = step(model, state, ef, b)
            want.append(float(m["loss"]))
    finally:
        torch.distributed.destroy_process_group()
    assert losses == want


def test_reduced_config_lives_in_the_train_launcher():
    assert tserve.reduced_config is ttrain.reduced_config
    for arch in ARCHS:
        cfg = ttrain.reduced_config(TC.get(arch))
        assert cfg.d_model == 256 and cfg.vocab == 1024 and not cfg.remat
