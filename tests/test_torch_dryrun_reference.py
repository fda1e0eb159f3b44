"""The port's compile analysis against the JAX package's.

The same step, at the SMOKE configs and B 2, S 64, is counted on both
sides: the port's on ``meta`` tensors by ``repro_torch.launch.op_count``
(through ``launch.dryrun.run_cell``), the reference's compiled under
``make_host_mesh()`` and ``make_ctx`` and walked by
``repro.launch.hlo_count.analyze``.  The reference must lower under the
mesh: without one its MoE layer takes the meshless ``_moe_ffn_local``,
which runs every expert on every token.

* decode and prefill: equal FLOPs on all 10 configs (DeepSeek-V2-Lite's
  latent attention runs the flash kernel with v at its own width);
* train: the port counts more by a closed form in the attention and SSD
  layer counts (see ``_train_extra``);
* parameter counts, the active parameters and the flash I/O bytes equal
  the reference's at full size.
"""
import importlib
import os

import jax
import pytest

from repro import configs as RC
from repro.launch import hlo_analysis as RH
from repro.launch.hlo_count import analyze as hlo_analyze
from repro.launch.mesh import make_host_mesh
from repro.models.transformer import abstract_params as r_abstract
from repro.serve.serve_step import make_prefill_step, make_serve_step
from repro.sharding import make_ctx
from repro.train.optimizer import AdamW as RAdamW
from repro.train.train_step import make_train_step
from repro_torch import configs as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TR
from repro_torch.models.transformer import abstract_params, count_params

B, S = 2, 64
KINDS = ("decode", "prefill", "train")


@pytest.fixture(scope="module", autouse=True)
def _smoke_shapes():
    """One smoke shape a kind in both registries, and JAX's caches cleared
    when the module ends (a later file that counts fresh traces starts
    cold)."""
    added = []
    for reg in (RC.SHAPES, TC.SHAPES):
        for kind in KINDS:
            reg[f"smoke_{kind}"] = {"seq": S, "batch": B, "kind": kind}
            added.append((reg, f"smoke_{kind}"))
    yield
    for reg, name in added:
        del reg[name]
    jax.clear_caches()


_REF: dict = {}


def reference_active_params():
    """``repro.launch.dryrun.active_params``.  That module sets XLA_FLAGS to
    512 host devices when it is imported (the reference's dry run fakes
    them in its own process), so the import restores the variable: the
    tests see the real host."""
    kept = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun").active_params
    finally:
        if kept is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = kept


def reference_flops(arch: str, kind: str) -> float:
    """The reference's HLO FLOPs of the SMOKE step, lowered under the host
    mesh (memoised across the module's tests)."""
    if (arch, kind) not in _REF:
        cfg = RC.smoke(arch)
        mesh = make_host_mesh()
        ctx = make_ctx(mesh)
        abstract = r_abstract(cfg)
        batch, _ = RC.input_specs(cfg, f"smoke_{kind}")
        if kind == "train":
            opt = RAdamW()
            fn = jax.jit(make_train_step(cfg, ctx, opt))
            args = (abstract, opt.init_abstract(abstract), batch)
        elif kind == "prefill":
            fn, args = jax.jit(make_prefill_step(cfg, ctx)), (abstract, batch)
        else:
            fn, args = jax.jit(make_serve_step(cfg, ctx)), (abstract, batch)
        with mesh:
            text = fn.lower(*args).compile().as_text()
        _REF[arch, kind] = hlo_analyze(text).flops
    return _REF[arch, kind]


def port_flops(arch: str, kind: str) -> float:
    rec = TD.run_cell(arch, f"smoke_{kind}", cfg=TC.smoke(arch))
    assert rec["status"] == "ok", rec
    return rec["roofline"]["flops_per_device"]


def _pv(cfg, d: int) -> int:
    """One (S, S) product of B·H rows over a width d: 2·B·H·S²·d."""
    h = cfg.mla.n_heads if cfg.attn_type == "mla" else cfg.n_heads
    return 2 * B * h * S * S * d


def _n_attention(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_every
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers   # self, self, cross
    return cfg.n_layers


def _train_extra(cfg) -> int:
    """What the port's train step counts beyond the reference's.

    An attention layer: two q·kᵀ products of 2·B·H·S²·Dh each.  The flash
    backward (``kernels.ops._flash_bwd``) streams the row lse from (q, k)
    and rebuilds P from (q, k, lse), where the reference's autodiff of the
    materialised softmax keeps P.  Latent attention's products are over
    q·k's width and v's own (the kernel takes v unpadded), so its extra is
    the same two q·kᵀ products.

    An SSD layer: two products the size of the state update,
    2·B·L·H·P·N each, at this geometry the net of the port's backward
    rerunning the whole chunk recurrence (``models.ssd.chunk_scan`` under
    autograd) against XLA's pruned recompute of the checkpointed
    ``chunk_step`` and its own contraction orders (``op_breakdown``)."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        per_attn = 2 * _pv(cfg, m.qk_nope + m.qk_rope)
    else:
        per_attn = 2 * _pv(cfg, cfg.hd)
    extra = _n_attention(cfg) * per_attn
    if cfg.ssd is not None:
        s = cfg.ssd
        extra += cfg.n_layers * 2 * (2 * B * S * s.n_heads * s.headdim
                                     * s.d_state)
    return extra


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_decode_flops_equal_the_reference(arch):
    assert port_flops(arch, "decode") == reference_flops(arch, "decode")


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_prefill_flops_equal_the_reference(arch):
    assert port_flops(arch, "prefill") == reference_flops(arch, "prefill")


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_train_flops_differ_by_the_backward_products(arch):
    cfg = TC.smoke(arch)
    extra = _train_extra(cfg)
    assert extra > 0
    assert port_flops(arch, "train") - reference_flops(arch, "train") == extra


def test_train_extra_per_layer_at_this_shape():
    """The constants the closed form gives at B 2, S 64: +2,097,152 a GQA
    attention layer, +1,048,576 an SSD layer."""
    dense, ssm = TC.smoke("internlm2_1_8b"), TC.smoke("mamba2_780m")
    assert _train_extra(dense) == dense.n_layers * 2_097_152
    assert _train_extra(ssm) == ssm.n_layers * 1_048_576


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    cfg, rcfg = TC.get(arch), RC.get(arch)
    port, ref = abstract_params(cfg), r_abstract(rcfg)
    assert count_params(port) == RH.count_params(ref)
    assert TR.count_params(port) == count_params(port)
    assert TD.active_params(cfg, port) == reference_active_params()(rcfg, ref)


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_flash_io_bytes_equal_the_reference(arch, shape):
    info = TC.SHAPES[shape]
    got = TR.flash_attention_io_bytes(TC.get(arch), info["seq"],
                                      info["batch"], info["kind"], 1)
    want = RH.flash_attention_io_bytes(RC.get(arch), info["seq"],
                                       info["batch"], info["kind"], 1)
    assert got == want


def test_model_flops_is_the_references():
    assert TR.model_flops(1.5e9, 4096) == RH.model_flops(1.5e9, 4096)
    cfg = TC.get("olmoe_1b_7b")
    assert TD.active_params(cfg, abstract_params(cfg)) < count_params(
        abstract_params(cfg))
