"""Mesh construction: the port of ``repro.launch.mesh`` over
``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` made by
``init_device_mesh`` over the process group that is running: one rank a
device, the ranks laid out row-major over the named axes, as
``jax.make_mesh`` lays out devices.  Every axis runs: the batch axes
``"pod"`` and ``"data"``, and ``"model"`` at any size, whose tensor,
expert and sequence parallelism and SSD heads the train, eval and serve
steps run (``train.train_step``, ``serve.serve_step``).  The launchers'
256- and 512-rank production meshes (``--mesh single|multi``) wait for
ROADMAP A.11f-2c.

Process groups.  ``start_group(device)`` starts the group of the ranks that
the environment names (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT``, as ``torchrun`` sets them); without them it starts a
one-rank group on an in-process store.  Its backend comes from the device:
NCCL on the card, gloo on the CPU, and nothing else (a failed NCCL start
raises).  ``make_mesh``, ``make_host_mesh`` and ``make_production_mesh``
call it when no group is running, and only they do: importing this module,
a serve run and ``host_mesh_shape`` start nothing.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..kernels.build import PlanError
from ..kernels.ops import resolve_device

AXES = ("pod", "data", "model")


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def start_group(device=None) -> None:
    """Start the process group if none is running: the environment's ranks
    (``torchrun``'s variables, ``env://``) or one rank on a ``HashStore``.
    On the card each rank takes the device of its ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if env_world_size() > 1:
        dist.init_process_group(_backend(dev), init_method="env://")
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)


def env_world_size() -> int:
    """The ranks the environment starts (``torchrun``'s ``WORLD_SIZE``;
    1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    """Ranks in the running group (1 when none is running)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, names, device=None):
    """A ``DeviceMesh`` of ``shape`` over the axes ``names`` (a subset of
    "pod", "data", "model" in that order) on ``device``'s type, over the
    running group (started here if none is; its size must be the mesh's)."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or any(n not in AXES for n in names) \
            or list(names) != sorted(names, key=AXES.index):
        raise PlanError(f"mesh axes {names} of shape {shape}: the axes are "
                        f"a subset of {AXES}, in that order, one size each")
    dev = resolve_device(device)
    start_group(dev)
    if math.prod(shape) != dist.get_world_size():
        raise PlanError(f"mesh {dict(zip(names, shape))} needs "
                        f"{math.prod(shape)} ranks; the group has "
                        f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 × 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod (the
    reference's ``:24``).  Raises unless the group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() != math.prod(shape):
        raise PlanError(f"the production mesh {dict(zip(names, shape))} "
                        f"needs {math.prod(shape)} ranks; the group has "
                        f"{world_size()}")
    return make_mesh(shape, names, device)


def make_host_mesh(device=None):
    """Every rank of the running group on the data axis: ("data", "model")
    = (world, 1) (the reference's ``:31``; one rank when none is running)."""
    start_group(device)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)


def mesh_shape(mesh) -> dict:
    """``{axis: size}``: what the reference prints as ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def host_mesh_shape() -> dict:
    """``make_host_mesh``'s shape, without starting a group."""
    return {"data": world_size(), "model": 1}
