"""The closed-form counts against ``torch.utils.flop_counter`` on plain
computations of the same work, and against the figures the kernel table
recorded for the same shapes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.counts import flash, model
from bench.reference import model as ref

DENSE = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv": 2, "head_dim": 16, "d_ff": 96, "vocab": 300,
         "rope_theta": 10000.0, "norm_eps": 1e-6, "tie_embeddings": False}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("b,s,h,hkv,dqk,dv", [(1, 7, 2, 1, 8, 8),
                                              (2, 16, 4, 2, 16, 8)])
def test_flash_flops_are_the_causal_pairs(b, s, h, hkv, dqk, dv):
    q, k = torch.randn(b, s, h, dqk), torch.randn(b, s, h, dqk)
    v = torch.randn(b, s, h, dv)

    def causal_rows():          # query i against its keys 0..i
        for i in range(s):
            qi = q[:, i].reshape(b * h, 1, dqk)
            ki = k[:, :i + 1].permute(0, 2, 3, 1).reshape(b * h, dqk, i + 1)
            vi = v[:, :i + 1].permute(0, 2, 1, 3).reshape(b * h, i + 1, dv)
            torch.bmm(torch.bmm(qi, ki), vi)
    assert counted(causal_rows) == flash.flops(b, s, h, dqk, dv)


def test_flash_bound_matches_the_kernel_table():
    # Zamba2-2.7B's long prefill, B 4 x 4096, 32 heads of 80: 343.7 GFLOP
    assert flash.flops(4, 4096, 32, 80, 80) / 1e9 == pytest.approx(343.7,
                                                                   abs=0.05)
    # InternLM2 training at 8 x 256 (16 heads over 8, 128): 25.2 MB
    assert flash.nbytes(8, 256, 16, 8, 128, 128) / 1e6 == pytest.approx(
        25.2, abs=0.05)


@pytest.mark.parametrize("tied", [False, True])
def test_dense_forward_flops_against_the_reference(tied):
    c = {**DENSE, "tie_embeddings": tied}
    b, s = 2, 12
    w = {n: torch.randn(shape) * 0.1 for n, (shape, _, _)
         in ref.schema(c).items()}
    tokens = torch.randint(0, DENSE["vocab"], (b, s))
    got = counted(lambda: ref.logits(w, ref.hidden(w, tokens, c,
                                                   ref.Ops()), c, ref.Ops()))
    # the reference scores every (query, key) pair and masks; the count
    # keeps the causal ones
    full = 4 * b * DENSE["n_heads"] * s * s * DENSE["head_dim"]
    causal = flash.flops(b, s, DENSE["n_heads"], DENSE["head_dim"],
                         DENSE["head_dim"])
    want = model.forward_flops(DENSE, b, s, head_positions=s) \
        + DENSE["n_layers"] * (full - causal)
    assert got == want
    assert model.train_flops(DENSE, b, s) == 3 * model.forward_flops(
        DENSE, b, s, s)
