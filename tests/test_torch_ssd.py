"""The port's SSD on the CPU against the JAX package: the plain ``ssd_scan``
against the Pallas kernel in interpret mode over the reference sweep of
``tests/test_ssd_kernel.py`` at its tolerances (2e-4 float32, 5e-2
bfloat16), plus the state-carry case; the torch twin of ``ssd_chunk_ref``;
the port's ``ssd_forward`` and ``ssd_decode_step`` against the reference's
on carried weights; and, in the port alone, chunked against stepwise,
chunk-size invariance and causality (``tests/test_ssd.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssd as RS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.build import PlanError
from repro_torch.models import ssd as TS
from repro_torch.models.convert import state_dict_from_reference

SWEEP = [
    (2, 256, 4, 64, 128, 128, "f32"),
    (1, 512, 2, 64, 64, 256, "f32"),
    (2, 256, 8, 32, 128, 64, "f32"),
    (1, 256, 4, 64, 128, 128, "bf16"),
]
TOL = {"f32": 2e-4, "bf16": 5e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


def _inputs(b, l, h, p, n, seed=3):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, l, h, p), np.float32)
    bm = rng.standard_normal((b, l, n), np.float32) * np.float32(0.3)
    cm = rng.standard_normal((b, l, n), np.float32) * np.float32(0.3)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.2).astype(np.float32)
    return xs, bm, cm, dt, a


def _both(arrays, dtype):
    """(jax, torch) operands: a stays float32, the rest in ``dtype``."""
    j = [jnp.asarray(x).astype(JNP[dtype]) for x in arrays[:4]]
    t = [torch.from_numpy(x).to(TORCH[dtype]) for x in arrays[:4]]
    return j + [jnp.asarray(arrays[4])], t + [torch.from_numpy(arrays[4])]


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype", SWEEP)
def test_ssd_scan_matches_the_pallas_kernel(b, l, h, p, n, chunk, dtype):
    jargs, targs = _both(_inputs(b, l, h, p, n), dtype)
    want = np.asarray(pallas_ssd_scan(*jargs, chunk=chunk, interpret=True),
                      np.float32)
    before = ss.LAUNCHES
    y_plain, state = ss.ssd_scan_plain(*targs, chunk)
    y_ops, state_ops = ops.ssd_scan(*targs, chunk=chunk)
    assert ss.LAUNCHES == before
    for y in (y_plain, y_ops):
        assert y.dtype == TORCH[dtype] and y.shape == (b, l, h, p)
        np.testing.assert_allclose(y.float().numpy(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    assert torch.equal(state, state_ops)


def test_ssd_scan_state_carries_across_chunks():
    """Decay about 1: positions in chunk 3 see only the carried state."""
    b, l, h, p, n = 1, 256, 2, 32, 64
    rng = np.random.default_rng(5)
    xs = np.zeros((b, l, h, p), np.float32)
    xs[:, :64] = rng.standard_normal((b, 64, h, p))
    bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    dt = np.full((b, l, h), 0.05, np.float32)
    a = np.full((h,), -0.01, np.float32)
    jargs, targs = _both((xs, bm, cm, dt, a), "f32")
    want = np.asarray(pallas_ssd_scan(*jargs, chunk=64, interpret=True))
    got, _ = ops.ssd_scan(*targs, chunk=64)
    assert float(got[:, 200:].abs().max()) > 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_ssd_chunk_ref_twin_matches_the_reference_oracle():
    arrays = _inputs(2, 64, 2, 16, 16, seed=9)
    jargs, targs = _both(arrays, "f32")
    want = np.asarray(ssd_chunk_ref(*jargs, chunk=16))
    np.testing.assert_allclose(tref.ssd_chunk_ref(*targs, chunk=16).numpy(),
                               want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 96, 2, 16, 16), 64, "multiple"),        # 96 % 64
    ((1, 64, 2, 128, 16), 64, "headdim"),         # P past 64
    ((1, 64, 2, 16, 256), 64, "d_state"),         # N past 128
    ((1, 2048, 1, 16, 16), 2048, "at most"),      # Q past 1024
])
def test_ssd_scan_refuses_what_the_kernel_cannot_take(shape, chunk, match):
    _, targs = _both(_inputs(*shape), "f32")
    with pytest.raises(PlanError, match=match):
        ops.ssd_scan(*targs, chunk=chunk)


def test_ssd_scan_refuses_mixed_dtypes():
    _, (xs, bm, cm, dt, a) = _both(_inputs(1, 64, 2, 16, 16), "f32")
    with pytest.raises(PlanError, match="share"):
        ops.ssd_scan(xs, bm.bfloat16(), cm, dt, a, chunk=16)
    with pytest.raises(PlanError, match="a must be float32"):
        ops.ssd_scan(xs, bm, cm, dt, a.double(), chunk=16)


def _carried(cfg_kw, seed):
    """The reference SSD layer's parameters and the port's layer holding
    the same weights."""
    rcfg, tcfg = RS.SSDConfig(**cfg_kw), TS.SSDConfig(**cfg_kw)
    tree = jax.tree.map(np.asarray, RS.ssd_init(jax.random.key(seed), rcfg))
    rng = np.random.default_rng(seed)
    # nonzero A_log / dt_bias / conv_b so every parameter matters
    for name in ("A_log", "dt_bias", "conv_b"):
        tree[name] = (rng.standard_normal(tree[name].shape) * 0.3
                      ).astype(np.float32)
    layer = TS.SSD(tcfg, None, "cpu")
    layer.load_state_dict(state_dict_from_reference(tree), strict=True)
    return rcfg, tcfg, tree, layer


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_forward_and_decode_match_the_reference(chunk):
    kw = dict(d_model=48, d_state=8, headdim=8, chunk=chunk)
    rcfg, tcfg, tree, layer = _carried(kw, seed=0)
    x = (np.random.default_rng(1).standard_normal((2, 32, 48)) * 0.1
         ).astype(np.float32)
    y_ref, h_ref = RS.ssd_forward(tree, jnp.asarray(x), rcfg)
    y, h = TS.ssd_forward(layer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5,
                               rtol=1e-4)
    b = x.shape[0]
    rstate = {"h": jnp.zeros((b, rcfg.n_heads, rcfg.headdim, rcfg.d_state)),
              "conv": jnp.zeros((b, rcfg.conv_width - 1, rcfg.conv_dim))}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in rstate.items()}
    for t in range(4):
        yr, rstate = RS.ssd_decode_step(tree, jnp.asarray(x[:, t:t + 1]),
                                        rcfg, rstate)
        yt, tstate = TS.ssd_decode_step(layer, torch.from_numpy(
            x[:, t:t + 1]), tcfg, tstate)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yr), atol=1e-5,
                                   rtol=1e-4)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tstate[k].float().numpy(),
                                       np.asarray(rstate[k], np.float32),
                                       atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_equals_stepwise(chunk):
    cfg = TS.SSDConfig(d_model=48, d_state=8, headdim=8, chunk=chunk)
    layer = TS.ssd_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b, length = 2, 32
    x = torch.randn((b, length, 48), generator=torch.Generator().manual_seed(1)
                    ) * 0.1
    y_full, h_full = TS.ssd_forward(layer, x, cfg)
    state = {"h": torch.zeros((b, cfg.n_heads, cfg.headdim, cfg.d_state)),
             "conv": torch.zeros((b, cfg.conv_width - 1, cfg.conv_dim))}
    outs = []
    for t in range(length):
        yt, state = TS.ssd_decode_step(layer, x[:, t:t + 1], cfg, state)
        outs.append(yt)
    torch.testing.assert_close(torch.cat(outs, dim=1), y_full, atol=3e-4,
                               rtol=1e-3)
    torch.testing.assert_close(state["h"], h_full, atol=3e-4, rtol=1e-3)


def test_chunk_size_invariance():
    """Different chunkings of the same sequence give the same outputs."""
    b, length, d = 1, 48, 32
    x = torch.randn((b, length, d), generator=torch.Generator().manual_seed(2)
                    ) * 0.1
    outs = []
    for chunk in (4, 12, 16, 48):
        cfg = TS.SSDConfig(d_model=d, d_state=8, headdim=8, chunk=chunk)
        layer = TS.ssd_init(cfg, torch.Generator().manual_seed(3), "cpu")
        outs.append(TS.ssd_forward(layer, x, cfg)[0])
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=3e-4, rtol=1e-3)


def test_state_causality():
    """Changing a future token does not change past outputs."""
    cfg = TS.SSDConfig(d_model=32, d_state=8, headdim=8, chunk=8)
    layer = TS.ssd_init(cfg, torch.Generator().manual_seed(4), "cpu")
    x1 = torch.randn((1, 24, 32), generator=torch.Generator().manual_seed(5)
                     ) * 0.1
    x2 = x1.clone()
    x2[0, 20] = 99.0
    y1, _ = TS.ssd_forward(layer, x1, cfg)
    y2, _ = TS.ssd_forward(layer, x2, cfg)
    torch.testing.assert_close(y1[0, :20], y2[0, :20], atol=1e-5, rtol=0)
    assert not torch.allclose(y1[0, 20:], y2[0, 20:])
