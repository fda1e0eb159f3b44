"""The port's flash attention on the CPU against the JAX package's Pallas
kernel (interpret mode, as its own tests run it): the plain version and
``ops.flash_attention`` on CPU tensors, over the reference sweep of
``tests/test_flash_attention.py`` plus Zamba2's head_dim 80, at the
reference's tolerances (2e-5 float32, 2e-2 bfloat16), and at lengths off
the TPU kernel's tiles against the reference oracle.  The torch twin of
``ref.mha_ref`` is held against the reference oracle, and the operands the
kernel's contract refuses raise ``PlanError``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
TOL = {"f32": 2e-5, "bf16": 2e-2}
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
