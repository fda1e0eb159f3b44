"""The port's serve driver (``repro_torch.launch.serve``) at ``--reduced`` on
the CPU against the JAX package: its prompts equal the ones the reference
driver builds (the same ``generate``, LyreSplit and fused checkout wave),
and its greedy tokens equal the reference's ``greedy_decode`` from the same
carried weights, in float32 compute (both packages' ``COMPUTE_DTYPE``
patched inside the test), for the dense, ssm and hybrid families.  The
driver's prefill check passes and reports no kernel launch on the CPU."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import generate, lyresplit_for_budget, to_tree
from repro.data import VersionedDataset
from repro.launch.mesh import make_host_mesh
from repro.launch.train import reduced_config as ref_reduced_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.checkout import BatchedCheckoutServer
from repro.serve.serve_step import greedy_decode, make_serve_step
from repro.sharding import make_ctx
from repro_torch import configs as TC
from repro_torch.launch import serve as tserve
from repro_torch.models import from_reference
from repro_torch.models import layers as TL

PROMPT_LEN, REQUESTS, DECODE = 64, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference's traces are cached process-wide; drop them when this
    module ends, so that a later test file in the same process that counts
    fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


def _reference_prompts(vocab, prompt_len, requests, versions, seed=0):
    """The reference driver's prompt lines (``repro.launch.serve.main``)."""
    w = generate("CUR", n_versions=8, inserts=400, n_branches=2,
                 n_attrs=prompt_len, seed=seed)
    tree, _ = to_tree(w.graph, w.vgraph)
    sr = lyresplit_for_budget(tree, gamma=2.0 * w.n_records)
    ds = VersionedDataset.from_graph(w.graph, w.data % vocab,
                                     sr.best.assignment, seq_len=prompt_len)
    vids = [v if v >= 0 else w.n_versions - 1 for v in versions]
    server = BatchedCheckoutServer(ds.store, use_kernel=True)
    server.warmup()
    waves = server.serve(vids)
    per_v = max(requests // len(vids), 1)
    pool = np.concatenate([m[:per_v] for m in waves])
    reps = -(-requests // len(pool))
    rows = np.tile(pool, (reps, 1))[:requests]
    return (rows[:, :prompt_len] % vocab).astype(np.int32)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_780m",
                                  "zamba2_2_7b"])
def test_serve_driver_matches_the_reference(arch, monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    rcfg = ref_reduced_config(RC.get(arch))
    tcfg = tserve.reduced_config(TC.get(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.key(0)))
    run = tserve.serve(tcfg, requests=REQUESTS, prompt_len=PROMPT_LEN,
                       decode_steps=DECODE, prompt_version="3,5,7",
                       device="cpu",
                       params=from_reference(tcfg, tree, device="cpu"),
                       log=lambda *_: None)

    prompts = _reference_prompts(rcfg.vocab, PROMPT_LEN, REQUESTS, [3, 5, 7])
    np.testing.assert_array_equal(run["prompts"], prompts)

    ctx = make_ctx(make_host_mesh())
    step = jax.jit(make_serve_step(rcfg, ctx))
    cache = RT.init_cache(rcfg, REQUESTS, PROMPT_LEN + DECODE)
    p = jnp.asarray(prompts)
    for i in range(PROMPT_LEN - 1):      # the last prompt token starts decode
        _, cache = step(tree, {"tokens": p[:, i:i + 1], "cache": cache})
    want, _ = greedy_decode(tree, rcfg, ctx, p, DECODE, cache)
    np.testing.assert_array_equal(run["tokens"], np.asarray(want))

    check = run["check"]
    assert check["ok"] and max(check["rel_l2"]) < 1e-4
    assert run["launches"] == {
        "fill_decode": {"flash_attention": 0, "ssd_scan": 0},
        "prefill": {"flash_attention": 0, "ssd_scan": 0}}
    cache = run["cache"]
    if "len" in cache:                  # the ssm cache has no length
        assert cache["len"] == PROMPT_LEN + DECODE - 1
        kv = cache["k" if "k" in cache else "shared_k"]
        assert kv.shape[2] == PROMPT_LEN + DECODE


def test_serve_main_prints_the_reference_fields(capsys):
    """``--reduced --device cpu`` runs end to end (bf16 compute) and prints
    the reference driver's JSON fields, then the prefill's."""
    rc = tserve.main(["--arch", "zamba2_2_7b", "--reduced", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "16",
                      "--decode-steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "checkout wave" in lines[0]
    result = json.loads(lines[-1])
    assert rc == 0 and result["prefill_ok"]
    for key in ("arch", "requests", "prefill_s", "decode_s",
                "decode_tok_per_s", "sample", "prefill_step_s",
                "prefill_rel_l2_max", "prefill_bound", "launches"):
        assert key in result
    assert result["requests"] == 2 and len(result["sample"]) == 3
