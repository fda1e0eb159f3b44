"""The port's flash attention on the CPU against the JAX package's Pallas
kernel (interpret mode, as its own tests run it): the plain version and
``ops.flash_attention`` on CPU tensors, over the reference sweep of
``tests/test_flash_attention.py`` plus Zamba2's head_dim 80, at the
reference's tolerances (2e-5 float32, 2e-2 bfloat16), and at lengths off
the TPU kernel's tiles against the reference oracle.  Latent attention's
widths (q·k 192, v 128, and a small pair like it) against the Pallas
kernel on v zero-padded to q's width, the output sliced back (exact by
construction: the padding's columns of the output are its own), forward
and the ``_FlashAttention`` gradients against ``jax.vjp`` of the
reference's custom VJP on the padded v, dV sliced (relative L2: float32
within 2e-5, bf16 within 2 · 2^-8, the bound ``tests/test_torch_train.py``
derives for the flash Function's bf16 gradients).  The torch twin of
``ref.mha_ref`` is held against the reference oracle, and the operands the
kernel's contract refuses raise ``PlanError``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.ref import mha_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import PlanError

SWEEP = [
    (2, 256, 4, 2, 128, "f32", True),
    (1, 256, 4, 4, 128, "f32", False),
    (2, 512, 8, 2, 128, "f32", True),
    (1, 384, 6, 2, 128, "f32", True),     # non-pow2 seq (÷128)
    (2, 256, 4, 1, 128, "bf16", True),    # MQA, bf16
    (1, 256, 2, 2, 256, "f32", True),     # wider head
    (2, 256, 4, 4, 80, "bf16", True),     # Zamba2's head_dim
    (1, 128, 4, 2, 80, "f32", False),
]
# latent attention's widths: (B, S, H, Hkv, Dqk, Dv, dtype, causal)
LATENT = [
    (1, 128, 2, 2, 192, 128, "f32", True),    # DeepSeek-V2-Lite's widths
    (1, 128, 4, 2, 192, 128, "bf16", True),   # GQA, bf16
    (2, 128, 2, 1, 192, 128, "f32", False),   # MQA, no mask
    (1, 256, 4, 4, 48, 32, "bf16", False),    # a narrower pair, two tiles
]
TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = {"f32": 2e-5, "bf16": 2 * 2.0 ** -8}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


def _inputs(b, s, h, hkv, dh, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh), np.float32),
            rng.standard_normal((b, s, hkv, dh), np.float32),
            rng.standard_normal((b, s, hkv, dh), np.float32))


def _both(arrays, dtype):
    return ([jnp.asarray(a).astype(JNP[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays])


@pytest.mark.parametrize("b,s,h,hkv,dh,dtype,causal", SWEEP)
def test_flash_matches_the_pallas_kernel(b, s, h, hkv, dh, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, s, h, hkv, dh), dtype)
    want = np.asarray(flash_attention_fwd(jq, jk, jv, causal=causal,
                                          interpret=True), np.float32)
    before = fa.LAUNCHES
    for got in (fa.flash_attention_plain(tq, tk, tv, causal),
                ops.flash_attention(tq, tk, tv, causal)):
        assert got.dtype == TORCH[dtype] and got.shape == tq.shape
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.LAUNCHES == before           # the CPU never launches


@pytest.mark.parametrize("causal", [True, False])
def test_mha_ref_twin_matches_the_reference_oracle(causal):
    arrays = _inputs(1, 64, 4, 2, 16, seed=3)
    for dtype in ("f32", "bf16"):
        (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
        want = np.asarray(mha_ref(jq, jk, jv, causal=causal), np.float32)
        got = tref.mha_ref(tq, tk, tv, causal=causal).float().numpy()
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,dtype,causal", [
    (1, 200, 200, 4, 2, 64, "f32", True),     # 200 % 128: a ragged tile
    (2, 77, 77, 2, 1, 80, "bf16", True),      # shorter than one tile
    (1, 128, 192, 4, 4, 32, "f32", False),    # Sk 192 % 128
    (1, 200, 328, 2, 2, 16, "bf16", False),
])
def test_flash_takes_lengths_off_the_tpu_tiles(b, sq, sk, h, hkv, dh, dtype,
                                               causal):
    """The TPU kernel takes multiples of its 128-row tiles; the port takes
    any length, as the reference model's materialised softmax does.  Held
    against the reference oracle on the same (rounded) operands in float32,
    at the kernel's tolerance."""
    rng = np.random.default_rng(11)
    arrays = (rng.standard_normal((b, sq, h, dh), np.float32),
              rng.standard_normal((b, sk, hkv, dh), np.float32),
              rng.standard_normal((b, sk, hkv, dh), np.float32))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    want = np.asarray(mha_ref(*(x.astype(jnp.float32) for x in (jq, jk, jv)),
                              causal=causal), np.float32)
    for got in (fa.flash_attention_plain(tq, tk, tv, causal),
                ops.flash_attention(tq, tk, tv, causal)):
        assert got.dtype == TORCH[dtype] and got.shape == tq.shape
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype], rtol=TOL[dtype])


def _latent(b, s, h, hkv, dqk, dv, seed=13):
    """q, k, v (v dv wide) and v zero-padded to dqk, as numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dqk), np.float32)
    k = rng.standard_normal((b, s, hkv, dqk), np.float32)
    v = rng.standard_normal((b, s, hkv, dv), np.float32)
    return q, k, v, np.pad(v, ((0, 0),) * 3 + ((0, dqk - dv),))


@pytest.mark.parametrize("b,s,h,hkv,dqk,dv,dtype,causal", LATENT)
def test_latent_widths_match_the_pallas_kernel_on_padded_v(
        b, s, h, hkv, dqk, dv, dtype, causal):
    q, k, v, vp = _latent(b, s, h, hkv, dqk, dv)
    (jq, jk, jvp), (tq, tk, tv) = (
        [jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, vp)],
        [torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)])
    want = np.asarray(flash_attention_fwd(jq, jk, jvp, causal=causal,
                                          interpret=True),
                      np.float32)[..., :dv]
    # v as latent attention makes it: a view of wider rows
    wide = torch.cat([tk, tv], dim=-1)[..., dqk:]
    before = fa.LAUNCHES
    for got in (fa.flash_attention_plain(tq, tk, tv, causal),
                ops.flash_attention(tq, tk, tv, causal),
                ops.flash_attention(tq, tk, wide, causal)):
        assert got.dtype == TORCH[dtype] and got.shape == (b, s, h, dv)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.LAUNCHES == before           # the CPU never launches


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("b,s,h,hkv,dqk,dv,dtype,causal", LATENT)
def test_latent_gradients_match_the_reference_vjp_on_padded_v(
        b, s, h, hkv, dqk, dv, dtype, causal):
    q, k, v, vp = _latent(b, s, h, hkv, dqk, dv, seed=17)
    do = np.random.default_rng(19).standard_normal((b, s, h, dv),
                                                   np.float32)
    jdt = JNP[dtype]
    out, vjp = jax.vjp(lambda a, c, e: rops.flash_attention(a, c, e, causal,
                                                            True),
                       *(jnp.asarray(t).astype(jdt) for t in (q, k, vp)))
    dop = np.pad(do, ((0, 0),) * 3 + ((0, dqk - dv),))
    wq, wk, wv = vjp(jnp.asarray(dop).astype(jdt))
    tq, tk, tv = (torch.from_numpy(t).to(TORCH[dtype]).requires_grad_(True)
                  for t in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal)
    o.backward(torch.from_numpy(do).to(TORCH[dtype]))
    assert tv.grad.shape == tv.shape
    host = (lambda t: t.detach().float().numpy())
    jhost = (lambda t: np.asarray(t, np.float32))
    tol = GRAD_TOL[dtype]
    assert _rel(host(o), jhost(out)[..., :dv]) <= tol
    for got, want in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        assert got.dtype == TORCH[dtype]
        want = jhost(want)[..., :got.shape[-1]]
        assert _rel(host(got), want) <= tol, (_rel(host(got), want), tol)


def test_v_pitch_reads_a_view_of_wider_rows():
    """The wgmma instance reads v at its row pitch: a contiguous v has Dv,
    the view ``kv[..., dn:]`` kv's row; a v whose rows do not lie evenly
    apart (heads of a fused row, a transposed view) has none and is
    copied before a launch."""
    kv = torch.zeros((2, 8, 3, 40))
    assert fa.v_pitch(kv[..., 24:].contiguous()) == 16
    assert fa.v_pitch(kv[..., 24:]) == 40
    assert fa.v_pitch(kv[:1, :, :, 24:]) == 40
    fused = torch.zeros((2, 8, 5 * 16))           # (B, S, (H + 2 Hkv) · D)
    assert fa.v_pitch(fused[..., 32:].reshape(2, 8, 3, 16)) is None
    assert fa.v_pitch(torch.zeros((2, 3, 8, 16)).transpose(1, 2)) is None
    assert fa.v_pitch(kv[..., ::2]) is None


@pytest.mark.parametrize("vshape,match", [
    ((1, 128, 2, 96), "wider than q"),        # Dv 96 > Dqk 64
    ((1, 128, 2, 0), "outside"),              # Dv 0
])
def test_flash_refuses_a_v_wider_than_q_or_empty(vshape, match):
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(PlanError, match=match):
        ops.flash_attention(q, q, torch.zeros(vshape))


@pytest.mark.parametrize("qshape,kshape,match", [
    ((1, 128, 2, 512), (1, 128, 2, 512), "head_dim"),  # Dh past 256
    ((1, 128, 3, 64), (1, 128, 2, 64), "multiple of Hkv"),
    ((1, 128, 2, 64), (1, 128, 2, 32), "do not match"),
])
def test_flash_refuses_what_the_kernel_cannot_take(qshape, kshape, match):
    q, k = torch.zeros(qshape), torch.zeros(kshape)
    with pytest.raises(PlanError, match=match):
        ops.flash_attention(q, k, k)


def test_flash_refuses_mixed_dtypes():
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(PlanError, match="float32 or bfloat16"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(PlanError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), q.half(), q.half())
