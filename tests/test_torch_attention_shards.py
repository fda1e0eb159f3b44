"""Attention weights on the model axis where the kv heads do not divide it:
the working copy keeps each rank's storage shards of ``wq``/``wk``/``wv``
(columns) and ``wo`` (rows), and a layer gathers a weight whole, in the
compute dtype, only around its use (``models.layers.at_use``); its
gradient returns straight to the shard.  No card and no jax: the layout,
and the dry run on ``meta`` under the production meshes' counting groups
(``launch.mesh.counting_group``).  The numerics across gloo ranks against
the reference are ``tests/test_torch_seq_parallel.py``'s and
``tests/test_torch_mesh_serve.py``'s.

* ``train_step.working_specs(cfg, 16)`` for the five configs whose kv
  heads do not divide the production model axis of 16 (InternLM2-1.8B 8,
  Qwen1.5-4B 20, Mistral-NeMo-12B 8, Phi3-medium-14B 10, LLaVA-NeXT-34B
  8): every attention weight shards "model" (``wq``/``wk``/``wv`` their
  columns, ``wo`` its rows), and Qwen's q/k/v biases are whole.
* Their ``train_4k`` cells counted at full size as rank 0 of the 256-rank
  mesh (LLaVA's also of the 512-rank one): each rank's peak under its
  ceiling, ``PEAK_CEILING_GB`` (a whole float32 copy of these weights,
  their whole gradient and its reduce buffers put InternLM2's at 8.3 GB,
  Qwen's 19.8, Mistral's 43.0, Phi3's 53.2 and LLaVA's 128.0 and 125.6;
  so does any layout that holds them whole a step).
* On ``meta`` under the 256-rank counting group, a train step with remat
  in 2 microbatches of SMOKE configs with 2 kv heads of 24 (so the whole
  attention weights' shapes, (64, 96), (64, 48) and (96, 64), are no
  other tensor's), on the sequence-sharded residual (S 64) and on a whole
  one (S 72, which 16 does not divide): a tensor of a whole attention
  weight's shape is made only inside a block's forward or remat's
  recompute, in the compute dtype (the gathered weight), or by the
  backward (its whole gradient before the reduce-scatter or the slice);
  none in the working copy, the microbatch sum or the optimizer.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import counting_group
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import make_ctx
from repro_torch.train.train_step import working_specs

M_AXIS = 16
PEAK_CEILING_GB = {"internlm2_1_8b": 7, "qwen15_4b": 10,
                   "mistral_nemo_12b": 16, "phi3_medium_14b": 20,
                   "llava_next_34b": 45}
CELLS = [(a, "single") for a in PEAK_CEILING_GB] + [("llava_next_34b",
                                                     "multi")]


@pytest.mark.parametrize("arch", list(PEAK_CEILING_GB))
def test_working_copy_keeps_the_attention_shards(arch):
    cfg = configs.get(arch)
    assert not L.heads_split(cfg.n_kv, M_AXIS)
    specs = working_specs(cfg, M_AXIS)
    attn = [n for n in specs if ".attn." in n]
    assert len(attn) >= 4 * cfg.n_layers
    for n in attn:
        if n.endswith(".b"):
            assert specs[n] == (None,), (n, specs[n])
        else:
            want = ("model", None) if ".wo." in n else (None, "model")
            assert specs[n] == want, (n, specs[n])
    assert any(n.endswith(".b") for n in attn) == cfg.qkv_bias


@pytest.mark.parametrize("arch,mesh", CELLS,
                         ids=[f"{a}-{m}" for a, m in CELLS])
def test_train_4k_rank_peak_under_its_ceiling(arch, mesh):
    cost, chips, _ = dryrun.count_cell(configs.get(arch), "train_4k", mesh)
    assert chips == {"single": 256, "multi": 512}[mesh]
    assert cost.peak_estimate_bytes <= PEAK_CEILING_GB[arch] * 1e9, \
        cost.peak_estimate_bytes


@pytest.mark.parametrize("seq", [64, 72])
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "seamless_m4t_medium",
                                  "llava_next_34b"])
def test_no_whole_attention_weight_outside_a_block(arch, seq, monkeypatch):
    monkeypatch.setitem(configs.SHAPES, "shards_train",
                        {"seq": seq, "batch": 32, "kind": "train"})
    cfg = dataclasses.replace(configs.smoke(arch), n_heads=4, n_kv=2,
                              head_dim=24, remat=True, microbatches=2)
    d, hq, hkv = cfg.d_model, 4 * 24, 2 * 24
    whole = {(d, hq), (d, hkv), (hq, d)}
    depth = [0]
    real = T._maybe_remat

    def remat(apply, cfg):            # each block's apply: forward, recompute
        def block(*a, **kw):
            depth[0] += 1
            try:
                return apply(*a, **kw)
            finally:
                depth[0] -= 1
        return real(block, cfg)
    monkeypatch.setattr(T, "_maybe_remat", remat)
    made = []

    class Whole(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    t = getattr(t, "_local_tensor", t)
                    if tuple(t.shape) in whole:
                        phase = ("block" if depth[0] else "backward"
                                 if torch._C._current_graph_task_id() != -1
                                 else "outside")
                        made.append((phase, t.dtype, str(func)))
            return out

    with counting_group("single") as mesh:
        ctx = make_ctx(mesh)
        assert T.rows_layout({"tokens": torch.empty(1, seq)},
                             M_AXIS) is (seq % M_AXIS == 0)
        _, step, args = dryrun.cell_step(cfg, "shards_train",
                                         dryrun.rank_model(cfg, mesh), ctx)
        with Whole():
            step(*args)
    assert not [m for m in made if m[0] == "outside"], made
    inside = [m for m in made if m[0] == "block"]
    assert inside and {dt for _, dt, _ in inside} == {L.COMPUTE_DTYPE}
    assert any(m[0] == "backward" for m in made)
