"""The port's mesh and sharding helpers (``launch.mesh``, ``sharding``),
its parameter specs against the JAX package's, and checkpoints across mesh
shapes.

* ``tests/test_sharding.py``'s five cases on the port, on a one-rank gloo
  group this file starts in its own process (and ends when it is done);
* ``make_mesh``'s refusals: a mesh that is not the group's size (a model
  axis above 1 included: it is refused for its size, not for its axis),
  axes out of order; the production meshes;
* ``param_specs`` equal to the reference's leaf for leaf for all ten
  configs at full size (each port name against the reference leaf that
  ``models.convert`` maps it to, a stacked leaf without its leading layer
  ``None``; and ``convert.reference_specs`` of them equal to the
  reference's whole tree), ``moe_param_specs``, ``AdamW.state_specs``,
  ``ef_specs`` and ``_drop_fsdp``;
* on two spawned gloo ranks (``tests/torch_ranks.py``): a one-rank
  checkpoint restored onto (data, model) = (2, 1) and (1, 2) bit-exact,
  each rank holding its share; a save from two ranks equal to the
  one-rank save row for row; two pods' parameters and residuals restored
  onto one pod bit-exact, here on one rank and there on (1, 2, 1).  This
  is the port's ``test_elastic_restore_across_mesh_shapes``.
"""
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks as R
from repro import configs as RC
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import configs as TC
from repro_torch.kernels.build import PlanError
from repro_torch.launch import mesh as M
from repro_torch.models import (from_reference, reference_like,
                                to_reference)
from repro_torch.models.convert import reference_path, reference_specs
from repro_torch.models.moe import moe_param_specs
from repro_torch.models.transformer import abstract_params, param_specs
from repro_torch.sharding import (distribute, dp_spec, local,
                                  logical_to_sharding, make_ctx,
                                  mesh_context, shard)
from repro_torch.train import AdamW, CheckpointStore, ef_specs
from repro_torch.train.train_step import _drop_fsdp, ef_init_abstract


@pytest.fixture(scope="module")
def host_mesh():
    """The one-rank group and its host mesh; the group ends with the
    module, so no later test in this process sees it."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = M.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _spec(p) -> tuple:
    """A reference ``PartitionSpec`` as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


# ------------------------------------------- tests/test_sharding.py's --
def test_shard_noop_without_ctx():
    x = torch.ones(4, 4)
    assert shard(x, ("data", None)) is x


def test_shard_drops_missing_axes(host_mesh):
    from torch.distributed.tensor import Shard
    ctx = make_ctx(host_mesh)            # has data/model, no pod
    with mesh_context(ctx):
        x = torch.ones(4, 4)
        assert shard(x, (("pod", "data"), "model")) is x   # a rank's rows
        d = distribute({"x": x}, {"x": (None, None)}, host_mesh)["x"]
        y = shard(d, (("pod", "data"), "model"))
        assert y.shape == x.shape
        assert tuple(y.placements) == (Shard(0), Shard(1))


def test_dp_spec_uses_ctx_axes(host_mesh):
    with mesh_context(make_ctx(host_mesh)):
        s = dp_spec(None, None)
        assert s[0] in ("data", ("data",))


def test_logical_to_sharding_tree(host_mesh):
    from torch.distributed.tensor import Replicate, Shard
    specs = {"a": ("data", None), "b": {"c": (("pod", "data"), "model")}}
    sh = logical_to_sharding(specs, host_mesh)
    assert sh["a"].spec == ("data", None)
    assert sh["a"].placements == (Shard(0), Replicate())
    # pod dropped (mesh lacks it)
    assert sh["b"]["c"].spec == (("data",), "model")
    assert sh["b"]["c"].placements == (Shard(0), Shard(1))


def test_make_ctx_multi_pod_axes(host_mesh):
    ctx = make_ctx(host_mesh)
    assert ctx.dp == ("data",)
    assert ctx.tp == "model"
    assert (ctx.dp_size, ctx.tp_size, ctx.dp_rank) == (1, 1, 0)
    pods = make_ctx(M.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu"))
    assert pods.dp == ("pod", "data")


# ----------------------------------------------------------- the mesh --
def test_make_mesh_refusals(host_mesh):
    with pytest.raises(PlanError, match="needs 2 ranks"):
        M.make_mesh((1, 2), ("data", "model"), "cpu")
    with pytest.raises(PlanError, match="needs 2 ranks"):
        M.make_mesh((2, 1), ("data", "model"), "cpu")
    with pytest.raises(PlanError, match="order"):
        M.make_mesh((1, 1), ("model", "data"), "cpu")
    for multi in (False, True):
        with pytest.raises(PlanError, match="ranks"):
            M.make_production_mesh(multi_pod=multi, device="cpu")
    assert M.mesh_shape(host_mesh) == {"data": 1, "model": 1}
    assert M.host_mesh_shape() == {"data": 1, "model": 1}


def test_plain_tensor_distribute_on_one_rank_keeps_everything(host_mesh):
    cfg = R.tiny()
    model = from_reference(cfg, jax.tree.map(np.asarray, RT.init_params(
        _ref_tiny(), jax.random.key(0))), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    distribute(model, param_specs(cfg), host_mesh)
    for n, p in model.named_parameters():
        assert torch.equal(local(p), before[n]) and not p.requires_grad


# ---------------------------------------------------------- the specs --
def _ref_tiny():
    return RT.ArchConfig(name="tiny-ft", family="dense", n_layers=2,
                         d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
                         head_dim=16, tie_embeddings=True, remat=False,
                         microbatches=1)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_specs_match_reference(arch):
    want = R.flat(jax.tree.map(_spec, RT.param_specs(RC.get(arch)),
                               is_leaf=lambda x: isinstance(x, P)))
    got = param_specs(TC.get(arch))
    assert {reference_path(n) for n in got} == set(want)
    for name, spec in got.items():
        ref = want[reference_path(name)]
        stacked = reference_path(name) != name.replace(".", "/")
        assert spec == (ref[1:] if stacked else ref), (name, spec, ref)
    assert R.flat(reference_specs(got)) == want


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_lite_16b"])
def test_moe_param_specs_match_reference(arch):
    cfg = RC.get(arch).moe
    want = R.flat(jax.tree.map(_spec, RMOE.moe_param_specs(cfg),
                               is_leaf=lambda x: isinstance(x, P)))
    got = moe_param_specs(TC.get(arch).moe)
    assert {k.replace(".", "/"): v for k, v in got.items()} == want


def test_state_and_residual_specs_match_reference():
    specs = param_specs(TC.smoke("internlm2_1_8b"))
    rspecs = RT.param_specs(RC.smoke("internlm2_1_8b"))
    st = AdamW().state_specs(specs)
    rst = ropt.AdamW().state_specs(rspecs)
    assert st.step == _spec(rst.step) and st.m is specs and st.v is specs
    want = R.flat(jax.tree.map(_spec, rts.ef_specs(rspecs),
                               is_leaf=lambda x: isinstance(x, P)))
    for name, spec in ef_specs(specs).items():
        ref = want[reference_path(name)]     # ("pod", layer None, ...)
        stacked = reference_path(name) != name.replace(".", "/")
        assert spec == ((ref[0], *ref[2:]) if stacked else ref), name
    model = abstract_params(TC.smoke("internlm2_1_8b"))
    for n, e in ef_init_abstract(model, 2).items():
        p = dict(model.named_parameters())[n]
        assert e.device.type == "meta" and e.dtype == torch.float32
        assert tuple(e.shape) == (2, *p.shape)
    for spec in (("data", "model"), (("pod", "data"), None), ("model",
                                                              "data")):
        # jax writes a one-name tuple as the name
        got = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                    for e in _drop_fsdp(spec))
        assert got == _spec(rts._drop_fsdp(P(*spec)))


# ------------------------------------------------ across mesh shapes --
def test_elastic_restore_across_mesh_shapes(tmp_path, host_mesh):
    cfg = R.tiny()
    tree = jax.tree.map(np.asarray, RT.init_params(_ref_tiny(),
                                                   jax.random.key(1)))
    model = from_reference(cfg, tree, device="cpu")
    one = CheckpointStore(str(tmp_path / "one"), shard_rows=1 << 10)
    assert one.save(step=1, tree=to_reference(model, host=False),
                    meta={"cursor": 1}) == 0
    spec = {"one_rank": str(tmp_path / "one"),
            "two_rank": str(tmp_path / "two"),
            "pods": str(tmp_path / "pods"), "out": str(tmp_path / "seen")}
    R.spawn(R.elastic_case, 2, tmp_path, spec)
    seen = json.loads((tmp_path / "seen.json").read_text())
    assert seen["bitexact"] == {"2x1": True, "1x2": True}
    specs = R.flat(reference_specs(param_specs(cfg)))
    for key, axis in (("2x1", "data"), ("1x2", "model")):
        for k, (mine, whole) in seen["shares"][key].items():
            split = any(e == axis for e in specs[k])
            assert mine * (2 if split else 1) == whole, (key, k)
    # the two-rank save is the one-rank save, row for row
    two = CheckpointStore(str(tmp_path / "two"), shard_rows=1 << 10)
    np.testing.assert_array_equal(two.cvd.checkout(0), one.cvd.checkout(0))
    assert two.manifest["versions"]["0"]["layout"] == \
        one.manifest["versions"]["0"]["layout"]
    # two pods' state: each rank held its pod's residual row; onto one pod
    assert set(seen["ef_rows"].values()) == {1} and seen["pods_bitexact"]
    full = dict(np.load(tmp_path / "seen.npz"))
    pods = CheckpointStore(str(tmp_path / "pods"), shard_rows=1 << 10)
    like = {"params": reference_like(model),
            "ef": reference_like(model)}
    back = R.flat(pods.restore(
        seen["pods_vid"], mesh=M.make_mesh((1, 1, 1), ("pod", "data",
                                                       "model"), "cpu"),
        specs={"params": reference_specs(param_specs(cfg)),
               "ef": ef_specs(reference_specs(param_specs(cfg)))},
        treedef_like=like))
    assert set(back) == set(full)
    for k, v in full.items():
        np.testing.assert_array_equal(local(back[k]).numpy(), v, err_msg=k)
