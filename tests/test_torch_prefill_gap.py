"""Where the serving prefill and the token-by-token decode part in bf16, on
the CPU, for the dense SMOKE configs and the encoder-decoder's.

The prefill's attention core is the flash kernel (its plain version here:
q·kᵀ and the probabilities kept in float32, as the reference's TPU kernel
keeps them); the decode's is the materialised softmax, which rounds q·kᵀ
and the probabilities to bf16 as the reference's model code does.  With
the flash kernel's rounding on both paths the two agree exactly, so the
whole distance between them is the core's rounding; it stays within
``launch.serve.prefill_bound``.  The encoder-decoder's token path takes its
encoder K/V from the prefill's own encoder code (``chip_smoke
.fill_cross_cache``), so the encoder adds nothing to the distance, and its
decoder blocks part at their self- and cross-attention cores alone.

Run as a script, it prints the measurements ``launch.serve.prefill_bound``
rests on (PERF.md, its Findings):

    PYTHONPATH=src python tests/test_torch_prefill_gap.py
    XLA_FLAGS=--xla_allow_excess_precision=false \\
        PYTHONPATH=src python tests/test_torch_prefill_gap.py

the port's distance over 40 seeds and at depths 1-8 (the encoder-decoder
at decoder depths 1-8 too); the relative error
block by block on one seed; and the JAX package's own two paths on the
same weights (its Pallas flash kernel, in interpret mode, as the
prefill's core, as on its TPU target, against its decode), whose rounding
XLA's excess precision changes."""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch.serve import prefill_bound
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import layers as TL

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_cross_cache  # noqa: E402

DENSE = ["internlm2_1_8b", "qwen15_4b", "mistral_nemo_12b",
         "phi3_medium_14b"]
ENCDEC = "seamless_m4t_medium"
SEQ = 32
U = 2.0 ** -8


def _float32(q, k, v, causal, q_offset):
    """The flash kernel's rounding on both paths: q·kᵀ and the
    probabilities in float32, the output rounded once (routed as
    ``models.layers._sdpa_core`` routes)."""
    sq, sk = q.shape[1], k.shape[1]
    if q_offset == 0 and (sq == sk or (not causal and sq > 1)):
        return fa.flash_attention_plain(q, k, v, causal)
    out = ref.mha_ref(q.float(), k.float(), v.float(), causal, q_offset)
    return out.to(q.dtype)


def _model(cfg, seed: int):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _tokens(cfg):
    return torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, SEQ)).astype(np.int32))


def _frames(cfg):
    """Seeded frame embeddings for an encoder-decoder, as many as the
    decode cache has slots (the decode attends to every slot)."""
    return torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32))


def gap(cfg, model) -> float:
    """Relative L2 distance of the prefill's last-position logits from the
    token-by-token decode's, over both rows."""
    toks = _tokens(cfg)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _frames(cfg)
    with torch.inference_mode():
        pre = forward(model, batch, cfg, last_only=True)
        cache = init_cache(cfg, 2, SEQ, device="cpu")
        if cfg.family == "encdec":
            fill_cross_cache(model, cfg, cache, batch["enc_embeds"])
        for t in range(SEQ):
            logits, cache = decode_step(model, {"tokens": toks[:, t:t + 1]},
                                        cache, cfg)
    a, b = pre[:, -1, :cfg.vocab].float(), logits[:, -1].float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("arch", DENSE + [ENCDEC])
def test_the_prefill_gap_is_the_attention_core(arch, monkeypatch):
    cfg = TC.smoke(arch)
    model = _model(cfg, 3)
    assert 0 < gap(cfg, model) <= prefill_bound(cfg)
    monkeypatch.setattr(TL, "_sdpa_core", _float32)
    assert gap(cfg, model) == 0.0


def _trace(cfg, model) -> list:
    """(stage, relative distance in u) at the last position, the prefill
    against the decode: each attention and SwiGLU output, each SwiGLU's
    normalised input, the final hidden state."""
    recs, real_att, real_sw = [], TL.attention, TL.swiglu

    def att(*a, **k):
        out, c = real_att(*a, **k)
        recs.append(("attention", out[:, -1].float().clone()))
        return out, c

    def sw(p, x):
        out = real_sw(p, x)
        recs.append(("swiglu in", x[:, -1].float().clone()))
        recs.append(("swiglu", out[:, -1].float().clone()))
        return out
    TL.attention, TL.swiglu = att, sw
    toks = _tokens(cfg)
    try:
        with torch.inference_mode():
            forward(model, {"tokens": toks}, cfg, last_only=True)
            pre = list(recs)
            cache = init_cache(cfg, 2, SEQ, device="cpu")
            for t in range(SEQ):
                recs.clear()
                _, cache = decode_step(model, {"tokens": toks[:, t:t + 1]},
                                       cache, cfg)
    finally:
        TL.attention, TL.swiglu = real_att, real_sw
    return [(n, float((a - b).norm() / b.norm()) / U)
            for (n, a), (_, b) in zip(pre, recs)]


def _reference_paths(arch: str, model) -> tuple:
    """The JAX package's prefill with its Pallas flash kernel (interpret
    mode) as the core, and its decode, on ``model``'s weights:
    (distance of its materialised prefill, of its flash prefill) from its
    decode."""
    import jax
    import jax.numpy as jnp
    from repro import configs as RC
    from repro.kernels import flash_attention as RFA
    from repro.models import layers as RL
    from repro.models import transformer as RT
    cfg = RC.smoke(arch)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if path[0] == "layers":
            return np.stack([sd[".".join(("layers", str(i)) + path[1:])]
                             for i in range(node.shape[0])])
        return sd[".".join(path)]
    tree = fill(jax.eval_shape(lambda: RT.init_params(
        cfg, jax.random.key(0))), ())
    toks = jnp.asarray(_tokens(cfg).numpy())
    cache = RT.init_cache(cfg, 2, SEQ)
    step = jax.jit(functools.partial(RT.decode_step, cfg=cfg))
    for t in range(SEQ):
        dec, cache = step(tree, {"tokens": toks[:, t:t + 1]}, cache)
    dec = np.asarray(dec[:, -1, :cfg.vocab], np.float32)
    real = RL._sdpa_core

    def flash(q, k, v, causal, q_offset):
        if isinstance(q_offset, int) and q_offset == 0 \
                and q.shape[1] == k.shape[1]:
            return RFA.flash_attention_fwd(q, k, v, causal=causal,
                                           interpret=True)
        return real(q, k, v, causal, q_offset)
    out = []
    for core in (real, flash):
        RL._sdpa_core = core
        try:
            pre = RT.forward(tree, {"tokens": toks}, cfg, last_only=True)
        finally:
            RL._sdpa_core = real
        pre = np.asarray(pre[:, -1, :cfg.vocab], np.float32)
        out.append(float(np.linalg.norm(pre - dec) / np.linalg.norm(dec)))
    return tuple(out)


def main() -> int:
    for arch in DENSE + [ENCDEC]:
        cfg = TC.smoke(arch)
        g = np.array([gap(cfg, _model(cfg, s)) for s in range(3, 43)]) / U
        print(f"{arch}: 40 seeds, gap in u: min {g.min():.2f} median "
              f"{np.median(g):.2f} max {g.max():.2f} (seed "
              f"{3 + int(g.argmax())}); bound "
              f"{prefill_bound(cfg) / U:.2f} u")
    cfg0 = TC.smoke("phi3_medium_14b")
    for depth in (1, 2, 4, 8):
        cfg = dataclasses.replace(cfg0, n_layers=depth)
        g = np.array([gap(cfg, _model(cfg, s)) for s in range(3, 23)])
        print(f"phi3 SMOKE at depth {depth}: 20 seeds, largest gap "
              f"{g.max() / U:.2f} u, {g.max() / prefill_bound(cfg):.2f} of "
              f"the bound")
    cfg1 = TC.smoke(ENCDEC)
    for depth in (1, 2, 4, 8):
        cfg = dataclasses.replace(cfg1, n_layers=depth, n_enc_layers=depth)
        g = np.array([gap(cfg, _model(cfg, s)) for s in range(3, 23)])
        print(f"seamless SMOKE at depth {depth} + {depth}: 20 seeds, largest "
              f"gap {g.max() / U:.2f} u, {g.max() / prefill_bound(cfg):.2f} "
              f"of the bound")
    for seed in (3, 4):
        stages = _trace(cfg0, _model(cfg0, seed))
        print(f"phi3 SMOKE seed {seed}, block by block (u): " + ", ".join(
            f"{n} {r:.2f}" for n, r in stages))
    for seed in (3, 4, 5):
        model = _model(cfg0, seed)
        own, flash = _reference_paths("phi3_medium_14b", model)
        print(f"phi3 SMOKE seed {seed}: the port {gap(cfg0, model):.4f}; "
              f"the JAX package's materialised prefill {own:.4f}, its flash "
              f"prefill {flash:.4f}, from its decode")
    return 0


if __name__ == "__main__":
    sys.exit(main())
